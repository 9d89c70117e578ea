"""Parity of the port's search path and retrieval API (``repro_torch.search``,
``repro_torch.api``) with the reference package, on the CPU; and a static
check that the port imports nothing of JAX or of the reference.

Ids must be equal; scores within ``rtol=1e-5`` (float32 sums in another
order). On integer-valued data scores must be bit-equal.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.models.common import MeshCtx  # noqa: E402
from repro.search import distributed as jax_ds  # noqa: E402
from repro.search import twostage as jax_ts  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.search import distributed as ds  # noqa: E402
from repro_torch.search import twostage as ts  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return synthetic.embedding_corpus(2000, 64, n_clusters=8, intrinsic=16,
                                      seed=7)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(1)
    picks = rng.integers(0, corpus.shape[0], 24)
    return corpus[picks] + 0.01 * rng.standard_normal(
        (24, corpus.shape[1])).astype(np.float32)


# ---------------------------------------------------------------------------
# (b) the single-device Flat scan
# ---------------------------------------------------------------------------
SEARCH_CASES = [(17, 300, 16, 10), (5, 40, 8, 60), (9, 200, 12, 7)]


@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("case", SEARCH_CASES,
                         ids=[f"q{c[0]}-n{c[1]}-k{c[3]}" for c in SEARCH_CASES])
def test_search_matches_reference(case, with_alive):
    nq, n, d, k = case
    q, db = _normal(nq, (nq, d)), _normal(n, (n, d))
    alive = (np.random.default_rng(2).random(n) > 0.3) if with_alive \
        else None
    want = jax_ds.search(jnp.asarray(q), jnp.asarray(db), k,
                         MeshCtx(mesh=None),
                         alive=None if alive is None else jnp.asarray(alive))
    got = ds.search(torch.from_numpy(q), torch.from_numpy(db), k,
                    alive=None if alive is None else torch.from_numpy(alive))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL)


@pytest.mark.parametrize("with_alive", [False, True])
def test_search_cosine_matches_reference_cosine(with_alive):
    """The reference's cosine scan (``search/distributed.py:119-120``) calls
    ``jnp.linalg.norm(x, -1, keepdims=True)``: -1 is ``ord``, not ``axis``,
    so it divides by one matrix norm and ranks by inner product (ROADMAP.md
    queue C). The port normalizes each row, as the reference's ``l2_topk``
    and rerank do; it is held against the reference's cosine ``l2_topk``
    oracle on unit rows."""
    from repro.kernels.l2_topk.ref import l2_topk_ref

    q, db = _normal(3, (9, 12)), _normal(4, (200, 12))
    alive = (np.random.default_rng(2).random(200) > 0.3) if with_alive \
        else None
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    dn = db / np.linalg.norm(db, axis=1, keepdims=True)
    want = l2_topk_ref(jnp.asarray(qn), jnp.asarray(dn), 7, "cosine",
                       None if alive is None else jnp.asarray(alive))
    got = ds.search(torch.from_numpy(q), torch.from_numpy(db), 7, "cosine",
                    alive=None if alive is None else torch.from_numpy(alive))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL)


def test_search_integer_corpus_bit_equal():
    rng = np.random.default_rng(4)
    q = rng.integers(-2, 3, (11, 5)).astype(np.float32)
    db = rng.integers(-2, 3, (120, 5)).astype(np.float32)
    want = jax_ds.search(jnp.asarray(q), jnp.asarray(db), 30,
                         MeshCtx(mesh=None))
    got = ds.search(torch.from_numpy(q), torch.from_numpy(db), 30)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_search_mesh_branch_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="4-chip cell"):
        ds.search(torch.zeros((1, 2)), torch.zeros((3, 2)), 1,
                  mesh=object())


# ---------------------------------------------------------------------------
# (c) the full-space rerank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_rerank_candidates_matches_reference_with_pads(metric):
    rng = np.random.default_rng(6)
    q, db = _normal(1, (7, 24)), _normal(2, (50, 24))
    cand = rng.integers(0, 50, (7, 12)).astype(np.int32)
    cand[0, 5:] = -1          # a short stage-1 row
    cand[3, :] = -1           # a row with no candidate at all
    cand[4, 2] = cand[4, 1]   # a duplicate candidate: a tie
    want = jax_ts.rerank_candidates(jnp.asarray(q), jnp.asarray(db),
                                    jnp.asarray(cand), 8, metric)
    got = ts.rerank_candidates(torch.from_numpy(q), torch.from_numpy(db),
                               torch.from_numpy(cand), 8, metric)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL)
    assert np.all(np.isneginf(got[0].numpy()[3]))
    assert np.all(got[1].numpy()[3] == -1)


# ---------------------------------------------------------------------------
# (e) the slice end to end: an index the reference saved, searched by both
# ---------------------------------------------------------------------------
def test_port_loads_and_answers_like_reference_saved_index(
        corpus, queries, tmp_path):
    ref = jax_api.index_factory("RAE16,Flat,Rerank4",
                                reducer_kw={"steps": 150, "seed": 0})
    ref.build(corpus)
    ref.save(str(tmp_path / "idx"))
    want = ref.search(queries, 10)

    port = api.load_index(str(tmp_path / "idx"), device="cpu")
    assert isinstance(port, api.TwoStageIndex)
    got = port.search(queries, 10)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL)
    assert got.stats == want.stats
    # the same state hashes to the same fingerprint in both packages
    assert port.fingerprint() == ref.fingerprint()
    np.testing.assert_allclose(
        port.reducer.transform(queries).numpy(),
        np.asarray(ref.reducer.transform(queries)), rtol=RTOL, atol=1e-5)


def test_reference_loads_what_the_port_saved(corpus, queries, tmp_path):
    port = api.index_factory("RAE8,Flat,Rerank2",
                             reducer_kw={"steps": 60}, device="cpu")
    port.build(corpus)
    port.save(str(tmp_path / "idx"))
    want = port.search(queries, 5)
    got = jax_api.load_index(str(tmp_path / "idx")).search(queries, 5)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL)


# ---------------------------------------------------------------------------
# (f) factory grammar and persistence inside the port
# ---------------------------------------------------------------------------
# one spec per grammar form of the reference's round-trip test, plus Mut
# and Shard
ALL_SPEC_FORMS = [
    "Flat", "IVF32", "HNSW8", "SQ8", "PQ4x8", "Flat,SQ8",
    "IVF32,SQ8", "IVF32,PQ4x8",
    "PCA8,Flat", "PCA8,IVF32,Rerank2", "PCA8,HNSW8,Rerank2",
    "PCA8,SQ8,Rerank2", "PCA8,PQ4x8,Rerank2", "PCA8,IVF32,PQ4x8,Rerank2",
    "RAE8,Flat,Rerank2", "Mut,RAE64,IVF256,Rerank4", "RAE64,Shard8,Flat",
]


@pytest.mark.parametrize("spec", ALL_SPEC_FORMS)
def test_parse_matches_reference_and_round_trips(spec):
    import dataclasses

    parsed = api.parse_index_spec(spec)
    assert dataclasses.asdict(parsed) == dataclasses.asdict(
        jax_api.parse_index_spec(spec))
    assert str(parsed) == str(jax_api.parse_index_spec(spec))
    assert api.parse_index_spec(str(parsed)) == parsed


@pytest.mark.parametrize("bad", [
    "", " ,Flat", "RAE64", "Rerank4", "Flat,Flat", "IVF", "Flat9",
    "Bogus64,Flat", "Flat,Rerank4", "Flat,PCA32", "RAE64,PCA32,Flat",
    "RAE64,Rerank4,Flat", "RAE64,Flat,Rerank4,Rerank2", "RAE,Flat",
])
def test_parse_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError, match="bad index spec"):
        jax_api.parse_index_spec(bad)
    with pytest.raises(ValueError, match="bad index spec"):
        api.parse_index_spec(bad)


@pytest.mark.parametrize("spec,item", [
    ("PCA8,Flat", "item 8"), ("Mut,Shard2,Flat", "item 11"),
    ("Mut,Flat", "item 11"),
])
def test_factory_names_the_roadmap_item_of_unported_stages(spec, item):
    """The stages ``ROADMAP.md`` queue A items 8 (baseline reducers) and 11
    (``Mut``) ported, once refused, build and answer as the reference's
    stacks on an integer corpus: ids equal, scores within f32 rounding."""
    rng = np.random.default_rng(9)
    x = rng.integers(-8, 8, (300, 16)).astype(np.float32)
    q = x[:12] + 0.25
    port = api.index_factory(spec, device="cpu").build(x)
    want = jax_api.index_factory(spec).build(x)
    cls = "MutableIndex" if item == "item 11" else "TwoStageIndex"
    assert type(port).__name__ == type(want).__name__ == cls
    got, ref = port.search(q, 10), want.search(q, 10)
    np.testing.assert_array_equal(got.indices, np.asarray(ref.indices))
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-4)
    if item == "item 11":   # the PCA stack hashes its f32-rounded codes
        assert port.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("spec,cls", [
    ("IVF32,SQ8", "IVFSQ8Index"), ("RAE8,HNSW8,SQ8,Rerank2", "HNSWIndex"),
    ("Flat,SQ8", "SQ8Index"),
])
def test_factory_builds_the_quantized_stages_on_cpu(spec, cls, corpus,
                                                    queries):
    """The quantized stages (once refused, ROADMAP.md A9) build the
    reference's class on the CPU, and search."""
    kw = dict(reducer_kw={"steps": 5}, index_kw={})
    if "HNSW" in spec:
        kw["index_kw"] = {"ef_construction": 20}
    port = api.index_factory(spec, device="cpu", **kw)
    ref = jax_api.index_factory(spec, **kw)
    node, want = getattr(port, "base", port), getattr(ref, "base", ref)
    assert type(node).__name__ == type(want).__name__ == cls
    port.build(corpus[:500])
    res = port.search(queries, 10)
    assert res.indices.shape == (24, 10) and (res.indices >= 0).all()
    assert node.bytes_per_vector > 0


@pytest.mark.parametrize("spec", ["Flat", "RAE8,Flat,Rerank2"])
def test_save_load_round_trip(spec, corpus, queries, tmp_path):
    idx = api.index_factory(spec, reducer_kw={"steps": 40}, device="cpu")
    idx.build(corpus)
    res = idx.search(queries, 5)
    assert res.indices.shape == (24, 5) and res.latency_s > 0
    idx.save(str(tmp_path / "i"))
    back = api.load_index(str(tmp_path / "i"), device="cpu")
    res2 = back.search(queries, 5)
    np.testing.assert_array_equal(res2.indices, res.indices)
    np.testing.assert_array_equal(res2.scores, res.scores)
    assert back.fingerprint() == idx.fingerprint()


def test_twostage_add_set_params_and_per_call_k1(corpus, queries):
    idx = api.index_factory("RAE8,Flat,Rerank2", reducer_kw={"steps": 40},
                            device="cpu")
    idx.build(corpus[:1500])
    fp = idx.fingerprint()
    idx.add(corpus[1500:])
    assert idx.ntotal == 2000 and idx.fingerprint() != fp
    # the same fitted reducer over the whole corpus at once
    full = api.TwoStageIndex(idx.reducer, api.FlatIndex(device="cpu"),
                             rerank_factor=2, device="cpu").build(corpus)
    a, b = idx.search(queries, 5), full.search(queries, 5)
    np.testing.assert_array_equal(a.indices, b.indices)
    wide = idx.search(queries, 5, params=api.SearchParams(rerank_k1=100))
    assert wide.stats["rerank_evals"] == 128.0   # snapped up the ladder
    fp = idx.fingerprint()
    idx.set_params(api.SearchParams(rerank_k1=64))
    assert idx.rerank_k1 == 64 and idx.fingerprint() != fp
    assert idx.search(queries, 5).stats["rerank_evals"] == 64.0


def test_flat_alive_never_returns_dead_rows(corpus, queries):
    idx = api.FlatIndex(device="cpu").build(corpus)
    alive = np.ones(2000, bool)
    alive[::3] = False
    res = idx.search(queries, 20, alive=alive)
    assert not np.isin(res.indices, np.flatnonzero(~alive)).any()


def test_rae_transform_with_bias_adds_it_after_the_encode(corpus, tmp_path):
    """A reducer whose weights carry ``b_e`` (saved with ``use_bias``)
    encodes as the reference's ``core.rae.encode``: x @ W_e + b_e."""
    from repro.core import rae as jax_rae

    red = api.make_reducer("rae", 8, steps=20, device="cpu").fit(corpus)
    red.params_["b_e"] = torch.linspace(-1.0, 1.0, 8)
    red.save(str(tmp_path / "r"))
    back = api.load_reducer(str(tmp_path / "r"), device="cpu")
    want = jax_rae.encode({k: jnp.asarray(v.numpy())
                           for k, v in red.params_.items()},
                          jnp.asarray(corpus[:16]))
    np.testing.assert_allclose(back.transform(corpus[:16]).numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-5)


def test_knob_ladder_matches_reference():
    assert api.KNOB_LADDER == jax_api.KNOB_LADDER
    for v in (1, 8, 9, 100, 2048, 5000):
        assert api.snap_knob(v) == jax_api.snap_knob(v)
        assert api.next_rung(v) == jax_api.next_rung(v)


# ---------------------------------------------------------------------------
# (g) the port imports nothing of JAX or of the reference
# ---------------------------------------------------------------------------
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)
    assert "import jax" not in path.read_text()
