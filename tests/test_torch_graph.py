"""Parity of the port's HNSW graph tier (``repro_torch.kernels.graph_beam``,
``repro_torch.search.hnsw``, ``repro_torch.api.graph``) with the reference
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's hop runs its plain PyTorch version; the reference's runs
its numpy ref or its Pallas kernel in interpret mode.

Tolerances: ids and eval counts must be equal; scores within
``rtol=1e-5, atol=1e-4`` (float32 sums taken in another order). On
integer-valued inputs every product and sum is exact in float32, so scores
must be bit-equal there. The host graph build and the sequential search
are numpy in both packages and must agree bit for bit.

The CUDA hop is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.kernels.graph_beam import graph_beam as jax_graph_beam  # noqa: E402
from repro.kernels.graph_beam.ref import graph_beam_ref as jax_hop_ref  # noqa: E402
from repro.search import hnsw as jax_hnsw  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.kernels import graph_beam  # noqa: E402
from repro_torch.kernels.common import NEG_INF  # noqa: E402
from repro_torch.search import hnsw  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _corpus(n, d, seed):
    return jax_synthetic.embedding_corpus(n, d, n_clusters=4, intrinsic=8,
                                          seed=seed)


def _ints(seed, shape, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# (a) the hop: the port's plain version against the reference's
# ---------------------------------------------------------------------------
def _hop_case(seed, q_n, n, d, w, ef, integer=False, live=2,
              empty=NEG_INF):
    """Random hop inputs: ids in [-1, n), a descending beam with ``live``
    real entries and ``empty`` in the other slots."""
    rng = np.random.default_rng(seed)
    if integer:
        qs, db = _ints(seed, (q_n, d)), _ints(seed + 1, (n, d))
    else:
        qs = rng.standard_normal((q_n, d)).astype(np.float32)
        db = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(-1, n, (q_n, w)).astype(np.int32)
    bv = np.full((q_n, ef), empty, np.float32)
    bi = np.full((q_n, ef), -1, np.int32)
    for s in range(min(live, ef)):
        bv[:, s] = -0.25 * (s + 1) - (2 * d if integer else 0)
        bi[:, s] = s
    return qs, db, ids, bv, bi


def _port_hop(qs, db, ids, bv, bi, mask=None):
    v, i = graph_beam(*(torch.from_numpy(a.copy())
                        for a in (qs, db, ids, bv, bi)),
                      db_mask=None if mask is None else torch.from_numpy(mask))
    return v.numpy(), i.numpy()


# (q_n, n, d, w, ef): the reference's parity cases (ragged Q, W=1, ef > W,
# d=1) and its sweep
HOP_CASES = {"ragged_q": (7, 60, 16, 9, 8), "w1": (5, 30, 8, 1, 6),
             "ef_gt_w": (3, 20, 4, 3, 15), "d1": (4, 25, 1, 5, 4),
             "sweep": (16, 128, 32, 16, 10)}


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("name", list(HOP_CASES))
def test_hop_matches_reference_ref(name, integer):
    case = _hop_case(len(name), *HOP_CASES[name], integer=integer)
    v, i = _port_hop(*case)
    wv, wi = jax_hop_ref(*case)
    np.testing.assert_array_equal(i, wi)
    if integer:
        np.testing.assert_array_equal(v, wv)
    else:
        np.testing.assert_allclose(v, wv, rtol=RTOL, atol=ATOL)
    assert np.all(np.diff(v, axis=1) <= 0)          # sorted descending
    assert np.all(v[i < 0] == NEG_INF)              # canonical pads


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("name", ["ragged_q", "w1", "ef_gt_w", "d1"])
def test_hop_matches_reference_pallas_interpret(name, integer):
    case = _hop_case(len(name) + 1, *HOP_CASES[name], integer=integer)
    v, i = _port_hop(*case)
    wv, wi = jax_graph_beam(*(jnp.asarray(a) for a in case),
                            impl="pallas", interpret=True)
    np.testing.assert_array_equal(i, np.asarray(wi))
    if integer:
        np.testing.assert_array_equal(v, np.asarray(wv))
    else:
        np.testing.assert_allclose(v, np.asarray(wv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["neg_inf_beam", "all_masked", "db_mask",
                                  "empty_beam_int"])
def test_hop_edge_cases_match_reference(kind):
    q_n, n, d, w, ef = 6, 40, 8, 12, 9
    mask = None
    if kind == "neg_inf_beam":     # empty beam slots arrive as -inf
        case = _hop_case(11, q_n, n, d, w, ef, empty=-np.inf)
    elif kind == "all_masked":      # rows whose every slot is -1
        case = _hop_case(12, q_n, n, d, w, ef)
        case[2][::2] = -1
    elif kind == "db_mask":
        case = _hop_case(13, q_n, n, d, w, ef)
        mask = np.random.default_rng(0).random(n) > 0.4
        mask[:2] = True             # the beam's own entries (ids 0, 1)
    else:                           # no live beam entry, integer scores
        case = _hop_case(14, q_n, n, d, w, ef, integer=True, live=0)
    v, i = _port_hop(*case, mask=mask)
    wv, wi = jax_hop_ref(*case, db_mask=mask)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(v, wv, rtol=RTOL, atol=ATOL)
    if kind == "all_masked":        # a fully masked row is the beam itself
        np.testing.assert_array_equal(i[::2], case[4][::2])
        np.testing.assert_array_equal(v[::2], case[3][::2])
    if mask is not None:
        assert not np.isin(i, np.flatnonzero(~mask)).any()
    assert np.all(v[i < 0] == NEG_INF)


def test_hop_ties_go_to_the_beam_then_the_lower_slot():
    """Equal scores: the beam entry first, then the lower candidate slot
    (not the lower id, ``l2_topk``'s rule)."""
    db = np.zeros((6, 2), np.float32)            # every row scores the same
    q = np.zeros((1, 2), np.float32)
    ids = np.array([[5, 3, 4]], np.int32)
    bv = np.array([[0.0, NEG_INF, NEG_INF, NEG_INF]], np.float32)
    bi = np.array([[1, -1, -1, -1]], np.int32)
    v, i = _port_hop(q, db, ids, bv, bi)
    np.testing.assert_array_equal(i, [[1, 5, 3, 4]])
    np.testing.assert_array_equal(i, jax_hop_ref(q, db, ids, bv, bi)[1])


# ---------------------------------------------------------------------------
# (b) the host build and the sequential search: bitwise the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus():
    return _corpus(800, 16, seed=13)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(4)
    picks = rng.integers(0, corpus.shape[0], 24)
    return corpus[picks] + 0.01 * rng.standard_normal(
        (24, corpus.shape[1])).astype(np.float32)


@pytest.fixture(scope="module", params=[(0, 8), (3, 4)],
                ids=["seed0-M8", "seed3-M4"])
def graphs(request, corpus):
    """(reference graph, port graph) from one corpus and seed."""
    seed, m = request.param
    x = corpus[:600] if m == 4 else corpus
    return (jax_hnsw.build(x, M=m, ef_construction=40, seed=seed),
            hnsw.build(x, M=m, ef_construction=40, seed=seed))


def test_build_equals_reference_bitwise(graphs):
    ref, port = graphs
    for name in ("vecs", "levels", "links0", "links"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert port.entry == ref.entry and port.M == ref.M
    assert port.max_level >= 1
    np.testing.assert_array_equal(port.pack().vecs_sq, ref.pack().vecs_sq)


def test_levels_and_reassign_entry_match_reference(graphs):
    ref, port = graphs
    np.testing.assert_array_equal(hnsw.sample_levels(500, 8, 9),
                                  jax_hnsw.sample_levels(500, 8, 9))
    alive = np.ones(port.ntotal, bool)
    alive[port.entry] = False
    fields = ("vecs", "levels", "links0", "links", "entry", "M")
    a = jax_hnsw.HNSWGraph(**{f: getattr(ref, f) for f in fields})
    b = hnsw.HNSWGraph(**{f: getattr(port, f) for f in fields})
    assert hnsw.reassign_entry(b, alive) == jax_hnsw.reassign_entry(a, alive)
    with pytest.raises(ValueError, match="no alive node"):
        hnsw.reassign_entry(b, np.zeros(port.ntotal, bool))


@pytest.mark.parametrize("with_alive", [False, True])
def test_sequential_search_equals_reference(graphs, queries, with_alive):
    ref, port = graphs
    alive = None
    if with_alive:
        alive = np.random.default_rng(5).random(port.ntotal) > 0.3
        alive[port.entry] = True
    want = jax_hnsw.search(ref, queries, 10, ef_search=40, alive=alive)
    got = hnsw.search(port, queries, 10, ef_search=40, alive=alive)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (c) the batched driver against the reference's two exact-order drivers
# ---------------------------------------------------------------------------
def _port_batched(g, q, k, ef, **kw):
    s, i, e, h = hnsw.search_batched(g, q, k, ef_search=ef, device="cpu",
                                     **kw)
    return s.numpy(), i.numpy(), e.numpy(), h


@pytest.mark.parametrize("ef", [10, 64])
def test_batched_matches_reference_jit_and_np_drivers(graphs, queries, ef):
    ref, port = graphs
    got = _port_batched(port, queries, 10, ef)
    for impl, kw in (("jit", {}), ("np", {"frontier": 1})):
        want = jax_hnsw.search_batched(ref, queries, 10, ef_search=ef,
                                       impl=impl, **kw)
        np.testing.assert_array_equal(got[1], want[1], err_msg=impl)
        np.testing.assert_array_equal(got[2], want[2], err_msg=impl)
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
        assert got[3] == want[3], impl          # layer-0 hops


def test_batched_integer_corpus_bit_equal():
    """Integer-valued corpus: exact scores, so every driver agrees bit for
    bit, ties included."""
    x = _ints(21, (300, 6))
    q = _ints(22, (9, 6))
    ref = jax_hnsw.build(x, M=4, ef_construction=20, seed=1)
    port = hnsw.build(x, M=4, ef_construction=20, seed=1)
    got = _port_batched(port, q, 8, 16)
    for impl, kw in (("jit", {}), ("np", {"frontier": 1})):
        want = jax_hnsw.search_batched(ref, q, 8, ef_search=16, impl=impl,
                                       **kw)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b, err_msg=impl)


def test_batched_row_independent_and_deterministic(graphs, queries):
    _, port = graphs
    r1 = _port_batched(port, queries[:12], 10, 40)
    r2 = _port_batched(port, queries[:12], 10, 40)
    for a, b in zip(r1[:3], r2[:3]):
        np.testing.assert_array_equal(a, b)
    for i in (0, 5, 11):
        solo = _port_batched(port, queries[i:i + 1], 10, 40)
        np.testing.assert_array_equal(solo[0][0], r1[0][i])   # bitwise
        np.testing.assert_array_equal(solo[1][0], r1[1][i])
        np.testing.assert_array_equal(solo[2][0], r1[2][i])


def test_batched_ragged_shapes(corpus):
    """k > ef, k > N (a 6-node graph) and q=1 follow the reference."""
    x = corpus[:300]
    ref = jax_hnsw.build(x, M=6, ef_construction=40, seed=1)
    port = hnsw.build(x, M=6, ef_construction=40, seed=1)
    for nq in (1, 5):
        got = _port_batched(port, x[:nq], 7, 3)      # ef < k -> ef = k
        want = jax_hnsw.search_batched(ref, x[:nq], 7, ef_search=3,
                                       impl="jit")
        assert got[1].shape == (nq, 7)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    tiny_ref = jax_hnsw.build(x[:6], M=4, ef_construction=20, seed=0)
    tiny = hnsw.build(x[:6], M=4, ef_construction=20, seed=0)
    sc, ids, ev, _ = _port_batched(tiny, x[:3], 10, 64)
    want = jax_hnsw.search_batched(tiny_ref, x[:3], 10, impl="jit")
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_array_equal(ev, want[2])
    assert np.all(ids[:, 6:] == -1) and np.all(np.isneginf(sc[:, 6:]))
    assert np.all(np.isfinite(sc[ids >= 0]))


def test_batched_disconnected_node(corpus):
    """A node severed from the graph is never returned; the short beam
    pads (the same hand-mutation as the reference's test)."""
    g = hnsw.build(corpus[:8], M=4, ef_construction=20, seed=0)
    victim = max(range(8), key=lambda i: 0 if i == g.entry else
                 float(((g.vecs[i] - g.vecs[g.entry]) ** 2).sum()))
    g.links0[victim] = -1
    g.links0[g.links0 == victim] = -1
    g.links[g.links == victim] = -1
    g.packed = None
    sc, ids, _, _ = _port_batched(g, corpus[:4], 8, 64)
    assert not np.any(ids == victim)
    assert np.all(ids[:, 7:] == -1) and np.all(np.isneginf(sc[:, 7:]))


def test_batched_alive_mask(graphs, queries):
    ref, port = graphs
    alive = np.random.default_rng(6).random(port.ntotal) > 0.3
    alive[port.entry] = True
    got = _port_batched(port, queries, 10, 40, alive=alive)
    want = jax_hnsw.search_batched(ref, queries, 10, ef_search=40,
                                   impl="jit", alive=alive)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert not np.isin(got[1], np.flatnonzero(~alive)).any()
    alive[port.entry] = False
    with pytest.raises(ValueError, match="tombstoned"):
        _port_batched(port, queries, 10, 40, alive=alive)


# ---------------------------------------------------------------------------
# (d) HNSWIndex, persistence, the factory and the stack
# ---------------------------------------------------------------------------
def test_index_fingerprint_stats_and_reference_saved_dir(corpus, queries,
                                                         tmp_path):
    ref = jax_api.HNSWIndex(m=8, ef_construction=40, frontier=1).build(
        corpus)
    ref.save(str(tmp_path / "g"))
    port = api.load_index(str(tmp_path / "g"), device="cpu")
    assert isinstance(port, api.HNSWIndex)
    assert port.fingerprint() == ref.fingerprint()
    assert port.bytes_per_vector == ref.bytes_per_vector
    assert port.dim == ref.dim
    for q in (queries, queries[:1]):        # batched, then lone (host)
        got, want = port.search(q, 10), ref.search(q, 10)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL,
                                   atol=ATOL)
        assert got.stats == want.stats
    # the port builds the same index from the same corpus and seed
    built = api.HNSWIndex(m=8, ef_construction=40, frontier=1,
                          device="cpu").build(corpus)
    assert built.fingerprint() == ref.fingerprint()


def test_reference_loads_what_the_port_saved(corpus, queries, tmp_path):
    # frontier=1: the reference's host driver then runs the exact order
    port = api.HNSWIndex(m=4, ef_construction=30, frontier=1,
                         device="cpu").build(corpus[:500])
    port.save(str(tmp_path / "g"))
    ref = jax_api.load_index(str(tmp_path / "g"))
    assert ref.fingerprint() == port.fingerprint()
    np.testing.assert_array_equal(ref.search(queries, 5).indices,
                                  port.search(queries, 5).indices)


def test_load_single_layer_and_unpacked_saves(tmp_path):
    """A graph with no upper layer saves ``links`` as [0, N, M]; a save
    without ``packed_vecs_sq`` packs on load."""
    x = _corpus(6, 8, seed=2)
    ref = jax_api.HNSWIndex(m=32, ef_construction=20, seed=1).build(x)
    assert ref._g.links.shape[0] == 0
    ref.save(str(tmp_path / "g"))
    z = dict(np.load(tmp_path / "g" / "arrays.npz"))
    del z["packed_vecs_sq"]
    np.savez(tmp_path / "g" / "arrays.npz", **z)
    port = api.load_index(str(tmp_path / "g"), device="cpu")
    assert port._g.links.shape == (0, 6, 32)
    np.testing.assert_array_equal(port.search(x[:3], 4).indices,
                                  ref.search(x[:3], 4).indices)


def test_index_routing_and_knobs(corpus, queries, tmp_path):
    """CPU ``auto`` follows the reference (q=1 host, q>1 batched);
    True/False pin either engine; ``set_params`` moves the fingerprint;
    save/load round-trips."""
    idx = api.HNSWIndex(m=8, ef_construction=40, device="cpu").build(
        corpus[:500])
    assert "beam_hops" not in idx.search(queries[:1], 5).stats
    batch = idx.search(queries[:4], 5)
    assert batch.stats["beam_hops"] > 0
    pinned = api.HNSWIndex(m=8, batched=True, device="cpu")
    pinned._g = idx._g
    assert "beam_hops" in pinned.search(queries[:1], 5).stats
    seq = api.HNSWIndex(m=8, batched=False, device="cpu")
    seq._g = idx._g
    assert "beam_hops" not in seq.search(queries[:4], 5).stats
    np.testing.assert_array_equal(seq.search(queries[:4], 5).indices,
                                  batch.indices)
    assert seq.fingerprint() != idx.fingerprint()
    fp = idx.fingerprint()
    wide = idx.search(queries[:4], 5, params=api.SearchParams(ef_search=100))
    assert wide.stats["distance_evals"] > batch.stats["distance_evals"]
    idx.set_params(api.SearchParams(ef_search=100))
    assert idx.ef_search == 128 and idx.fingerprint() != fp
    idx.save(str(tmp_path / "g"))
    back = api.load_index(str(tmp_path / "g"), device="cpu")
    assert back.fingerprint() == idx.fingerprint()
    np.testing.assert_array_equal(back.search(queries, 5).indices,
                                  idx.search(queries, 5).indices)


def test_stack_from_reference_reducer_and_graph(tmp_path):
    """``RAE64,HNSW32,Rerank4`` saved by the reference answers with the
    same ids in the port; k1 = 10 * 4 * 2 and ef = max(64, 80)."""
    x = _corpus(800, 128, seed=5)
    rng = np.random.default_rng(3)
    q = x[rng.integers(0, 800, 16)] + 0.01 * rng.standard_normal(
        (16, 128)).astype(np.float32)
    ref = jax_api.index_factory("RAE64,HNSW32,Rerank4",
                                reducer_kw={"steps": 60, "seed": 0},
                                index_kw={"ef_construction": 40,
                                          "frontier": 1})
    ref.build(x)
    ref.save(str(tmp_path / "s"))
    port = api.load_index(str(tmp_path / "s"), device="cpu")
    assert isinstance(port.base, api.HNSWIndex)
    assert port.stage1_k(10) == 80
    got, want = port.search(q, 10), ref.search(q, 10)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL)
    assert port.fingerprint() == ref.fingerprint()
    assert got.stats["stage1_distance_evals"] > 0


def test_factory_builds_hnsw_stack_on_cpu(corpus, queries):
    idx = api.index_factory("RAE8,HNSW8,Rerank4", reducer_kw={"steps": 30},
                            index_kw={"ef_construction": 30}, device="cpu")
    assert isinstance(idx.base, api.HNSWIndex) and idx.base.m == 8
    idx.build(corpus[:400])
    res = idx.search(queries, 10)
    assert res.indices.shape == (24, 10) and (res.indices >= 0).all()
    assert "beam_hops" in res.stats
    with pytest.raises(ValueError, match="euclidean only"):
        api.index_factory("HNSW8", metric="cosine", device="cpu")


@pytest.mark.parametrize("spec,item", [
    ("Mut,RAE64,HNSW32,Rerank4", "item 11"),
    ("Mut,RAE64,IVF256,Rerank4", "item 11"),
])
def test_factory_names_the_roadmap_item_of_unported_stages(spec, item):
    """The ``Mut`` stage (``ROADMAP.md`` queue A item 11, once refused)
    wraps the stack the reference's factory builds under it."""
    del item
    port = api.index_factory(spec, reducer_kw={"steps": 5}, device="cpu")
    want = jax_api.index_factory(spec, reducer_kw={"steps": 5})
    assert type(port).__name__ == type(want).__name__ == "MutableIndex"
    assert type(port._inner.base).__name__ == type(want._inner.base).__name__
    assert (port.imbalance_trigger, port.drift_tol, port.drift_threshold) \
        == (want.imbalance_trigger, want.drift_tol, want.drift_threshold)


def _storage(stack):
    """The storage index under a two-stage stack, or a shard's child."""
    base = getattr(stack, "base", stack)
    return base._shards[0] if hasattr(base, "_shards") else base


@pytest.mark.parametrize("spec", ["HNSW32,SQ8", "RAE64,HNSW32,PQ8x8,Rerank4",
                                  "Shard2,HNSW32,SQ8"])
def test_factory_builds_the_quantized_graph_stages_on_cpu(spec, corpus,
                                                          queries):
    """The quantized graph stages (once refused, ROADMAP.md A9) build the
    reference's classes, with its codec knobs, on the CPU, and search."""
    kw = dict(reducer_kw={"steps": 5}, index_kw={"ef_construction": 20})
    port = api.index_factory(spec, device="cpu", **kw).build(corpus[:300])
    want = jax_api.index_factory(spec, **kw)
    want = getattr(want, "base", want)
    if isinstance(want, jax_api.ShardedIndex):   # children come at build
        want = jax_api.index_factory(want.child_spec,
                                     index_kw=kw["index_kw"])
    node = _storage(port)
    assert type(node).__name__ == type(want).__name__ == "HNSWIndex"
    assert (node.quant, node.pq_m, node.pq_bits, node.stage1_oversample) \
        == (want.quant, want.pq_m, want.pq_bits, want.stage1_oversample)
    res = port.search(queries, 10)
    assert res.indices.shape == (24, 10) and (res.indices >= 0).all()
    assert np.isfinite(res.scores).all()


def test_unported_hnsw_options_name_their_items(corpus):
    """``HNSWIndex.add`` (once refused, naming item 11) inserts into the
    live graph as the reference's does: the same graph, bit for bit, and
    the new rows answer at once."""
    idx = api.HNSWIndex(m=4, ef_construction=20, device="cpu").build(
        corpus[:50])
    ref = jax_api.HNSWIndex(m=4, ef_construction=20).build(corpus[:50])
    ids = idx.add(corpus[50:60])
    np.testing.assert_array_equal(ids, ref.add(corpus[50:60]))
    g, rg = idx._g, ref._g
    for name in ("levels", "links0", "links"):
        np.testing.assert_array_equal(getattr(g, name), getattr(rg, name))
    assert g.entry == rg.entry and idx.fingerprint() == ref.fingerprint()
    assert set(idx.add_times) == {"insert_s", "upload_s"}
    res = idx.search(corpus[50:60], 1)
    np.testing.assert_array_equal(res.indices[:, 0], ids)
