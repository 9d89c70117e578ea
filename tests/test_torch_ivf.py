"""Parity of the port's IVF tier (``repro_torch.search.ivf``,
``repro_torch.api.IVFFlatIndex``) with the reference package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
reference's k-means draws its init with ``jax.random.choice``, which torch
cannot reproduce: the tests compute that draw with JAX and pass it to the
port's ``kmeans`` / ``build`` (``init=``), or load directories the
reference saved.

Tolerances: centroids within ``rtol=1e-5`` (plus ``atol=1e-6`` for
coordinates that cancel to near zero: float32 cell sums taken in another
order); assignments, list layouts, ids, stats and fingerprints equal. On
integer-valued corpora every score is exact in float32, so scores must be
bit-equal. Probed cells tie to the lower cell, as in the reference. The
candidates rank by (score descending, corpus id ascending), where the
reference ranks equal scores by slab position (``ROADMAP.md`` C8): so the
probe answers are held to the reference's scores, to its ids wherever a
score is not tied, and bit for bit to a numpy oracle that ranks the same
probed (score, id) pairs by (-score, id) (:func:`assert_probe_answer`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.search import ivf as jax_ivf  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.search import ivf  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def _int_corpus(n, d, seed=0):
    """Integer-valued f32: exact arithmetic, dense score ties."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, (n, d)).astype(np.float32)
    x[n // 2] = x[n // 3]  # planted duplicate rows -> guaranteed ties
    return x


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_init(n, n_clusters, seed):
    """The reference's k-means init draw (``search/ivf.py:36-37``)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        (n_clusters,), replace=False))


def _t(x):
    return torch.from_numpy(np.array(x))


def probe_oracle(full_v, full_i, k):
    """Each row's probed (score, id) pairs ranked by (score descending, id
    ascending) in numpy, the first ``k``; -inf slots carry id -1, and rows
    short of ``k`` pad with (-inf, -1)."""
    full_v, full_i = np.asarray(full_v), np.asarray(full_i)
    order = np.lexsort((full_i, -full_v), axis=1)[:, :k]
    v = np.take_along_axis(full_v, order, 1)
    i = np.where(np.isfinite(v), np.take_along_axis(full_i, order, 1), -1)
    pad = k - v.shape[1]
    if pad > 0:
        v = np.concatenate([v, np.full((v.shape[0], pad), -np.inf,
                                       v.dtype)], 1)
        i = np.concatenate([i, np.full((i.shape[0], pad), -1, i.dtype)], 1)
    return v, i


def assert_probe_answer(got, want, full, exact=True):
    """C8's comparison of an IVF probe answer ``got`` = (scores, ids) with
    the reference's ``want``: scores bit-equal (``exact``, integer
    corpora) or within f32 tolerance; ids equal to the reference's wherever
    the score is not tied in the probed slab; ids bit-equal to
    :func:`probe_oracle` over ``full``, every probed (score, id) pair of
    the reference. Returns the number of tied answer slots."""
    got_v, got_i = (np.asarray(a) for a in got)
    want_v, want_i = (np.asarray(a) for a in want)
    full_v, full_i = (np.asarray(a) for a in full)
    if exact:
        np.testing.assert_array_equal(got_v, want_v)
    else:
        np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=1e-4)
    np.testing.assert_array_equal(got_i, probe_oracle(full_v, full_i,
                                                      got_i.shape[1])[1])
    n_tied = 0
    for r in range(got_i.shape[0]):
        fin = full_v[r][np.isfinite(full_v[r])]
        vals, counts = np.unique(fin, return_counts=True)
        tied = np.isin(want_v[r], vals[counts > 1])
        n_tied += int(tied.sum())
        np.testing.assert_array_equal(got_i[r][~tied], want_i[r][~tied])
    return n_tied


def _port_ivf(ref: jax_ivf.IVFIndex) -> ivf.IVFIndex:
    """The reference's built index as the port's dataclass (same arrays)."""
    return ivf.IVFIndex(centroids=_t(ref.centroids), lists=_t(ref.lists),
                        list_vecs=_t(ref.list_vecs),
                        list_mask=_t(ref.list_mask), spill=ref.spill)


@pytest.fixture(scope="module")
def saved_ivf(tmp_path_factory):
    """A reference IVFFlatIndex over an integer corpus, saved to disk."""
    corpus = _int_corpus(509, 16, seed=3)
    ref = jax_api.IVFFlatIndex(n_cells=16, seed=2).build(corpus)
    d = str(tmp_path_factory.mktemp("ivf") / "idx")
    ref.save(d)
    return corpus, ref, d


# ---------------------------------------------------------------------------
# (a) k-means and the list fill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,c,iters,seed,integer", [
    (500, 8, 16, 10, 3, False), (301, 5, 7, 4, 0, False),
    (257, 16, 32, 10, 1, True), (64, 3, 64, 2, 5, False),
])
def test_kmeans_from_the_reference_init(n, d, c, iters, seed, integer):
    x = _int_corpus(n, d, seed) if integer else _normal(seed, (n, d))
    want_c, want_a = jax_ivf.kmeans(jnp.asarray(x), c, iters, seed)
    got_c, got_a = ivf.kmeans(torch.from_numpy(x), c, iters,
                              init=_jax_init(n, c, seed))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL,
                               atol=ATOL)


def test_kmeans_own_init_is_seeded_and_distinct():
    x = torch.from_numpy(_normal(0, (200, 4)))
    a, _ = ivf.kmeans(x, 9, 3, seed=4)
    b, _ = ivf.kmeans(x, 9, 3, seed=4)
    assert torch.equal(a, b)
    rows = ivf.init_rows(200, 9, seed=4)
    assert len(set(rows.tolist())) == 9
    assert not np.array_equal(rows, ivf.init_rows(200, 9, seed=5))


@pytest.mark.parametrize("cell_cap", [None, 20, 3])
@pytest.mark.parametrize("integer", [False, True])
def test_build_list_fill_bitwise(cell_cap, integer):
    n, d, c, seed = 401, 12, 16, 2
    x = _int_corpus(n, d, seed) if integer else _normal(seed, (n, d))
    ref = jax_ivf.build(jnp.asarray(x), c, cell_cap=cell_cap, seed=seed)
    got = ivf.build(torch.from_numpy(x), c, cell_cap=cell_cap, seed=seed,
                    init=_jax_init(n, c, seed))
    np.testing.assert_array_equal(got.lists.numpy(), np.asarray(ref.lists))
    np.testing.assert_array_equal(got.list_mask.numpy(),
                                  np.asarray(ref.list_mask))
    np.testing.assert_array_equal(got.list_vecs.numpy(),
                                  np.asarray(ref.list_vecs))
    assert got.spill == ref.spill
    assert got.lists.dtype == torch.int32
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(ref.centroids), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# (b) the probe scan on the reference's built index
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nprobe,k", [(1, 5), (4, 30), (16, 100)])
def test_probe_search_integer_corpus_bit_equal(nprobe, k):
    x = _int_corpus(509, 16, seed=4)
    q = _int_corpus(13, 16, seed=5)
    ref = jax_ivf.build(jnp.asarray(x), 16, seed=1)
    slab = nprobe * ref.lists.shape[1]
    k = min(k, slab)
    want = jax_ivf.search(ref, jnp.asarray(q), k, nprobe)
    full = jax_ivf.search(ref, jnp.asarray(q), slab, nprobe)
    got = ivf.search(_port_ivf(ref), torch.from_numpy(q), k, nprobe)
    assert_probe_answer((got[0].numpy(), got[1].numpy()), want, full)


def test_probe_ties_break_to_the_lower_id_c8():
    """A hand-made tie: two rows at one distance from the query, the
    higher id first in its list. The reference returns them in slab order
    (the higher id first); the port returns the lower id first, and keeps
    that order when the list is re-laid (C8)."""
    cent = torch.tensor([[0.0, 0.0], [10.0, 10.0]])
    vecs = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [3.0, 3.0]],
                         [[10.0, 10.0], [0.0, 0.0], [0.0, 0.0]]])
    mask = torch.tensor([[True, True, True], [True, False, False]])
    q = torch.tensor([[0.0, 0.0]])
    for lists in ([[7, 2, 5], [9, -1, -1]], [[2, 7, 5], [9, -1, -1]]):
        lists = torch.tensor(lists, dtype=torch.int32)
        index = ivf.IVFIndex(centroids=cent, lists=lists, list_vecs=vecs,
                             list_mask=mask, spill=0)
        v, i = ivf.search(index, q, 3, nprobe=1)
        assert i.tolist() == [[2, 7, 5]] and v.tolist() == [[-1.0, -1.0,
                                                             -18.0]]
        ref = jax_ivf.IVFIndex(centroids=jnp.asarray(cent.numpy()),
                               lists=jnp.asarray(lists.numpy()),
                               list_vecs=jnp.asarray(vecs.numpy()),
                               list_mask=jnp.asarray(mask.numpy()), spill=0)
        want = jax_ivf.search(ref, jnp.asarray(q.numpy()), 3, 1)
        assert np.asarray(want[1]).tolist() == [lists[0].tolist()]
    # -0.0 and +0.0 are one score: the lower id first
    s = torch.tensor([[0.0, -0.0, -1.0]])
    v, i = ivf.topk_by_score_then_id(s, torch.tensor([[4, 3, 1]]), 3)
    assert i.tolist() == [[3, 4, 1]]


def test_probe_search_float_corpus():
    x = _normal(6, (600, 24))
    q = _normal(7, (17, 24))
    ref = jax_ivf.build(jnp.asarray(x), 12, seed=0)
    want = jax_ivf.search(ref, jnp.asarray(q), 20, 3)
    got = ivf.search(_port_ivf(ref), torch.from_numpy(q), 20, 3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=1e-4)


def test_probe_search_in_query_chunks_answers_alike(monkeypatch):
    x = _int_corpus(300, 8, seed=8)
    q = torch.from_numpy(_int_corpus(11, 8, seed=9))
    index = ivf.build(torch.from_numpy(x), 8, seed=0)
    whole = ivf.search(index, q, 12, 4)
    # a budget of one query's slab: every query in a chunk of its own
    monkeypatch.setattr(ivf, "SLAB_BYTES", 1)
    one = ivf.search(index, q, 12, 4)
    assert torch.equal(whole[0], one[0]) and torch.equal(whole[1], one[1])


def test_recall_vs_exact_matches_the_reference():
    x = _normal(10, (400, 8))
    q = _normal(11, (20, 8))
    ref = jax_ivf.build(jnp.asarray(x), 8, seed=0)
    want = jax_ivf.recall_vs_exact(ref, jnp.asarray(x), jnp.asarray(q), 10,
                                   2)
    got = ivf.recall_vs_exact(_port_ivf(ref), torch.from_numpy(x),
                              torch.from_numpy(q), 10, 2)
    assert got == pytest.approx(want)


# ---------------------------------------------------------------------------
# (c) IVFFlatIndex against the reference's, from its saved directory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nprobe", [None, 8, 16])
@pytest.mark.parametrize("with_alive", [False, True])
def test_loaded_index_answers_like_the_reference(saved_ivf, nprobe,
                                                 with_alive):
    corpus, ref, d = saved_ivf
    port = api.load_index(d, device="cpu")
    assert isinstance(port, api.IVFFlatIndex)
    q = _int_corpus(9, 16, seed=6)
    alive = (np.random.default_rng(7).random(corpus.shape[0]) > 0.3
             if with_alive else None)
    p = None if nprobe is None else jax_api.SearchParams(nprobe=nprobe)
    want = ref.search(q, 30, alive=alive, params=p)
    full = ref.search(q, ref.ntotal, alive=alive, params=p)
    got = port.search(q, 30, alive=alive,
                      params=None if nprobe is None
                      else api.SearchParams(nprobe=nprobe))
    assert_probe_answer((got.scores, got.indices),
                        (want.scores, want.indices),
                        (full.scores, full.indices))
    assert got.stats == want.stats
    if with_alive:
        dead = np.flatnonzero(~alive)
        assert not np.isin(got.indices, dead).any()


def test_loaded_index_fingerprint_and_set_params(saved_ivf):
    _, ref, d = saved_ivf
    port = api.load_index(d, device="cpu")
    assert port.fingerprint() == ref.fingerprint()
    assert (port.ntotal, port.dim, port.bytes_per_vector) == (
        ref.ntotal, ref.dim, ref.bytes_per_vector)
    ref2 = jax_api.load_index(d)
    port.set_params(api.SearchParams(nprobe=12))
    ref2.set_params(jax_api.SearchParams(nprobe=12))
    assert port.nprobe == 12 and port.fingerprint() == ref2.fingerprint()
    assert port.fingerprint() != ref.fingerprint()


def test_k_beyond_the_probed_lists_pads_like_the_reference(saved_ivf):
    _, ref, d = saved_ivf
    port = api.load_index(d, device="cpu")
    q = _int_corpus(4, 16, seed=12)
    p = 1  # one probed cell holds far fewer than 400 rows
    want = ref.search(q, 400, params=jax_api.SearchParams(nprobe=p))
    got = port.search(q, 400, params=api.SearchParams(nprobe=p))
    assert got.indices.shape == (4, 400)
    assert_probe_answer((got.scores, got.indices),
                        (want.scores, want.indices),
                        (want.scores, want.indices))
    assert np.isneginf(got.scores[got.indices < 0]).all()


@pytest.mark.parametrize("n_new", [7, 300])  # 300 grows the list capacity
def test_add_and_cell_imbalance_match_the_reference(saved_ivf, tmp_path,
                                                    n_new):
    _, _, d = saved_ivf
    ref = jax_api.load_index(d)
    port = api.load_index(d, device="cpu")
    new = _int_corpus(n_new, 16, seed=13)
    ref.add(new)
    port.add(new)
    assert port.ntotal == ref.ntotal
    assert port.cell_imbalance() == ref.cell_imbalance()
    assert port.fingerprint() == ref.fingerprint()
    q = np.concatenate([new[:3], _int_corpus(3, 16, seed=14)])
    want, got = ref.search(q, 10), port.search(q, 10)
    full = ref.search(q, ref.ntotal)
    assert_probe_answer((got.scores, got.indices),
                        (want.scores, want.indices),
                        (full.scores, full.indices))
    assert got.stats == want.stats


def test_save_load_round_trip_both_ways(tmp_path):
    x = _normal(15, (300, 8))
    q = _normal(16, (6, 8))
    port = api.IVFFlatIndex(n_cells=8, device="cpu").build(x)
    port.save(str(tmp_path / "p"))
    again = api.load_index(str(tmp_path / "p"), device="cpu")
    ref = jax_api.load_index(str(tmp_path / "p"))
    assert again.fingerprint() == port.fingerprint() == ref.fingerprint()
    a, b = port.search(q, 5), again.search(q, 5)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.indices, np.asarray(ref.search(q, 5)
                                                        .indices))


def test_two_builds_give_one_fingerprint():
    x = _normal(17, (500, 8))
    a = api.IVFFlatIndex(n_cells=16, device="cpu").build(x)
    b = api.IVFFlatIndex(n_cells=16, device="cpu").build(x)
    assert a.fingerprint() == b.fingerprint()
    c = api.IVFFlatIndex(n_cells=16, seed=1, device="cpu").build(x)
    assert c.fingerprint() != a.fingerprint()


def test_index_surface_and_stats():
    x = _normal(18, (200, 8))
    idx = api.IVFFlatIndex(n_cells=300, device="cpu").build(x)  # > n rows
    assert idx._ivf.centroids.shape[0] == 200 and idx.nprobe == 18
    assert idx.bytes_per_vector == 36.0 and idx.dim == 8
    res = idx.search(_normal(19, (3, 8)), 4)
    assert res.indices.shape == (3, 4)
    assert res.stats["centroid_evals"] == 200.0
    assert 0 < res.distance_evals <= 200
    with pytest.raises(RuntimeError, match="search before build"):
        api.IVFFlatIndex(device="cpu").search(x[:1], 1)


# ---------------------------------------------------------------------------
# (d) the factory
# ---------------------------------------------------------------------------
def test_factory_builds_ivf_stacks(tmp_path):
    x = _normal(20, (400, 16))
    q = _normal(21, (5, 16))
    base = api.index_factory("IVF16", device="cpu")
    assert isinstance(base, api.IVFFlatIndex) and base.n_cells == 16
    stack = api.index_factory("RAE8,IVF16,Rerank2", reducer_kw={"steps": 20},
                              index_kw={"nprobe": 4}, device="cpu")
    assert isinstance(stack.base, api.IVFFlatIndex) and stack.base.nprobe == 4
    res = stack.build(x).search(q, 5)
    assert res.indices.shape == (5, 5) and (res.indices >= 0).all()
    assert res.stats["centroid_evals"] == 16.0
    stack.save(str(tmp_path / "s"))
    again = api.load_index(str(tmp_path / "s"), device="cpu").search(q, 5)
    np.testing.assert_array_equal(again.indices, res.indices)
    with pytest.raises(ValueError, match="euclidean only"):
        api.index_factory("IVF16", metric="cosine", device="cpu")
