"""Parity of the port's quantized HNSW payloads (``GraphCodes``,
``make_graph_codes``, the ``sq8`` / ``pq`` modes of ``search_batched`` and
``HNSWIndex(quant=...)``) with the reference package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
graphs are built by both packages (bitwise equal, as
``tests/test_torch_graph.py`` holds).
The reference's PQ codec draws its k-means init with ``jax.random.choice``:
the tests pass that draw to the port (``init=``, or the ``ref_draws``
fixture, which points the port's ``search.ivf.init_rows`` at it). On the
CPU the port's hop is ``graph_beam_q``'s plain version; the reference runs
its jitted traversal (``impl="jit"``) and its host driver at
``frontier=1``.

Tolerances: ids, eval counts and hop counts must be equal. The port sums
the hop operands (the ADC LUT, ``q.vmin``, the SQ8 norms) in a fixed
pairwise tree where the reference takes XLA's or numpy's order, so scores
are held within ``rtol=1e-5, atol=1e-4`` (the norms within ``rtol=1e-6``);
on integer-valued inputs every sum is exact and scores must be bit-equal.
A query's answer must not depend on its batch-mates, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.search import hnsw as jax_hnsw  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.search import hnsw, ivf  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _jax_init(n, n_clusters, seed):
    """The reference's k-means init draw (``search/ivf.py:36-37``)."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                      (n_clusters,), replace=False))


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(ivf, "init_rows", _jax_init)


@pytest.fixture(scope="module")
def corpus():
    return jax_synthetic.embedding_corpus(600, 16, n_clusters=4, intrinsic=8,
                                          seed=13)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(4)
    picks = rng.integers(0, corpus.shape[0], 20)
    return corpus[picks] + 0.01 * rng.standard_normal(
        (20, corpus.shape[1])).astype(np.float32)


@pytest.fixture(scope="module", params=[(0, 8), (3, 4)],
                ids=["seed0-M8", "seed3-M4"])
def graphs(request, corpus):
    """(reference graph, port graph) from one corpus and seed."""
    seed, m = request.param
    return (jax_hnsw.build(corpus, M=m, ef_construction=30, seed=seed),
            hnsw.build(corpus, M=m, ef_construction=30, seed=seed))


def _codecs(x, kind):
    """The reference's codec and the port's, trained from the same draws
    (PQ4x8: m = 4 subspaces of 4 dims, 15 Lloyd steps, seed 0)."""
    ref = jax_hnsw.make_graph_codes(x, kind, m=4, bits=8, iters=15, seed=0)
    init = [_jax_init(x.shape[0], min(256, x.shape[0]), mm)
            for mm in range(4)]
    port = hnsw.make_graph_codes(x, kind, m=4, bits=8, iters=15, seed=0,
                                 device="cpu", init=init)
    return ref, port


def _port_codec_of(ref):
    """The reference's trained codec as the port's (same arrays)."""
    return hnsw.GraphCodes(kind=ref.kind, codes=ref.codes,
                           node_bias=ref.node_bias, vmin=ref.vmin,
                           step=ref.step, codebooks=ref.codebooks)


_REF_CODECS = {}


def _attach(graphs, kind, corpus):
    """Both graphs carry the reference's codec (trained once per kind)."""
    ref, port = graphs
    if kind not in _REF_CODECS:
        _REF_CODECS[kind] = jax_hnsw.make_graph_codes(corpus, kind, m=4,
                                                      iters=15, seed=0)
    ref.codec = _REF_CODECS[kind]
    port.codec = _port_codec_of(ref.codec)
    return ref, port


def _batched(g, q, k, ef, **kw):
    s, i, e, h = hnsw.search_batched(g, q, k, ef_search=ef, device="cpu",
                                     **kw)
    return s.numpy(), i.numpy(), e.numpy(), h


# ---------------------------------------------------------------------------
# (a) the codec and its per-query operands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_make_graph_codes_matches_reference(kind, corpus):
    ref, port = _codecs(corpus, kind)
    assert port.kind == ref.kind and port.ksub == ref.ksub
    assert port.gather_bytes == ref.gather_bytes == (20 if kind == "sq8"
                                                     else 8)
    assert port.codes.dtype == np.uint8
    np.testing.assert_array_equal(port.codes, ref.codes)
    np.testing.assert_allclose(port.node_bias, ref.node_bias, rtol=1e-6)
    if kind == "sq8":
        np.testing.assert_array_equal(port.vmin, ref.vmin)
        np.testing.assert_array_equal(port.step, ref.step)
    else:
        assert port.vmin is None and ref.vmin is None
        np.testing.assert_allclose(port.codebooks, ref.codebooks,
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="'sq8' or 'pq'"):
        hnsw.make_graph_codes(corpus, "fp4", device="cpu")


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_query_operands_match_reference_and_are_row_independent(kind, corpus,
                                                                queries):
    ref, _ = _codecs(corpus, kind)
    port = _port_codec_of(ref)
    q = torch.from_numpy(queries)
    q_sq = (q * q).sum(1)
    q_op, q_bias = port.query_operands(q, q_sq)
    want = ref.query_operands(queries, q_sq.numpy())
    np.testing.assert_allclose(q_op.numpy(), want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(q_bias.numpy(), want[1], rtol=RTOL, atol=ATOL)
    # every reduction is a fixed tree: a row alone gives the same bits
    for r in (0, 7, 19):
        o, b = port.query_operands(q[r:r + 1], q_sq[r:r + 1])
        assert torch.equal(o[0], q_op[r]) and torch.equal(b[0], q_bias[r])


# ---------------------------------------------------------------------------
# (b) the quantized batched traversal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,ef", [("sq8", 10), ("pq", 48)])
def test_batched_matches_reference_jit_and_np_drivers(graphs, kind, ef,
                                                      corpus, queries):
    ref, port = _attach(graphs, kind, corpus)
    got = _batched(port, queries, 10, ef)
    for impl, kw in (("jit", {}), ("np", {"frontier": 1})):
        want = jax_hnsw.search_batched(ref, queries, 10, ef_search=ef,
                                       impl=impl, **kw)
        np.testing.assert_array_equal(got[1], want[1], err_msg=impl)
        np.testing.assert_array_equal(got[2], want[2], err_msg=impl)
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
        assert got[3] == want[3], impl          # layer-0 hops


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_batched_integer_payload_bit_equal(kind):
    """An SQ8 codec of step 1 (every dim spans 0..255) on integer queries,
    or an integer PQ codebook: every operand and score is exact, so the
    port equals the reference's jitted traversal bit for bit."""
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
    got = _batched(port, q, 8, 16)
    want = jax_hnsw.search_batched(ref, q, 8, ef_search=16, impl="jit")
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_batched_row_independent_and_masked(graphs, kind, corpus, queries):
    ref, port = _attach(graphs, kind, corpus)
    full = _batched(port, queries, 10, 32)
    for r in (0, 5, 19):                         # q=1 == its batch row
        one = _batched(port, queries[r:r + 1], 10, 32)
        np.testing.assert_array_equal(one[1][0], full[1][r])
        np.testing.assert_array_equal(one[0][0], full[0][r])
    alive = np.random.default_rng(2).random(ref.ntotal) > 0.3
    alive[ref.entry] = True
    got = _batched(port, queries, 10, 32, alive=alive)
    want = jax_hnsw.search_batched(ref, queries, 10, ef_search=32,
                                   impl="jit", alive=alive)
    np.testing.assert_array_equal(got[1], want[1])
    live = got[1][got[1] >= 0]
    assert alive[live].all()


# ---------------------------------------------------------------------------
# (c) HNSWIndex(quant=...), persistence and the factory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", ["sq8", "pq"])
def test_index_matches_reference(quant, corpus, queries, ref_draws):
    kw = dict(m=8, ef_construction=30, frontier=1, quant=quant, pq_m=4)
    ref = jax_api.HNSWIndex(**kw).build(corpus)
    port = api.HNSWIndex(device="cpu", **kw).build(corpus)
    assert port.bytes_per_vector == ref.bytes_per_vector
    assert port.stage1_oversample == ref.stage1_oversample == (
        8 if quant == "pq" else 2)
    for q in (queries, queries[:1]):             # q=1 pinned to batched
        got, want = port.search(q, 10), ref.search(q, 10)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL,
                                   atol=ATOL)
        assert got.stats == want.stats and "beam_hops" in got.stats
    with pytest.raises(ValueError, match="quant must be"):
        api.HNSWIndex(quant="fp4", device="cpu")
    with pytest.raises(ValueError, match="bits"):
        api.HNSWIndex(quant="pq", pq_bits=9, device="cpu")


def test_save_load_both_ways_and_fingerprints(corpus, queries, tmp_path):
    kw = dict(m=4, ef_construction=20, frontier=1)
    fps = {}
    for quant in (None, "sq8", "pq"):
        ref = jax_api.HNSWIndex(quant=quant, pq_m=4, **kw).build(corpus)
        ref.save(str(tmp_path / f"r{quant}"))
        port = api.load_index(str(tmp_path / f"r{quant}"), device="cpu")
        assert port.quant == quant
        assert port.fingerprint() == ref.fingerprint()
        np.testing.assert_array_equal(port.search(queries, 5).indices,
                                      ref.search(queries, 5).indices)
        port.save(str(tmp_path / f"p{quant}"))
        back = jax_api.load_index(str(tmp_path / f"p{quant}"))
        assert back.fingerprint() == ref.fingerprint()
        np.testing.assert_array_equal(back.search(queries, 5).indices,
                                      port.search(queries, 5).indices)
        fps[quant] = port.fingerprint()
    assert len(set(fps.values())) == 3           # f32, SQ8, PQ apart


@pytest.mark.parametrize("spec", ["RAE8,HNSW8,SQ8,Rerank4",
                                  "RAE8,HNSW8,PQ4x8,Rerank4"])
def test_factory_quantized_graph_stack_round_trip(spec, corpus, queries,
                                                  tmp_path):
    idx = api.index_factory(spec, reducer_kw={"steps": 20},
                            index_kw={"ef_construction": 20}, device="cpu")
    idx.build(corpus)
    assert idx.base.quant == ("sq8" if "SQ8" in spec else "pq")
    res = idx.search(queries, 10)
    assert res.indices.shape == (20, 10) and (res.indices >= 0).all()
    assert res.stats["stage1_distance_evals"] > 0
    idx.save(str(tmp_path / "s"))
    back = api.load_index(str(tmp_path / "s"), device="cpu")
    again = back.search(queries, 10)
    np.testing.assert_array_equal(again.indices, res.indices)
    np.testing.assert_array_equal(again.scores, res.scores)
    assert back.fingerprint() == idx.fingerprint()
