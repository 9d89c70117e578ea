"""Live mutation on the port (``repro_torch.api.MutableIndex``, the ``Mut``
factory prefix, ``search.hnsw.insert_batch``), on the CPU.

The 24 tests of the reference's ``tests/test_mutation.py``, mirrored on
the port (the last two through ``repro_torch.serve.SearchEngine``), with the same corpus (N, DIM, K =
200, 16, 10; small random integers cast to float32, so distances are exact
and self-hit assertions are deterministic):

* insert immediacy: a row returned by ``add`` answers the very next
  ``search``;
* tombstone exactness: a deleted id never surfaces, at every tier;
* identity: the epoch and the fingerprint move on every mutation, ids are
  stable across a compacting ``rebuild`` (the reference fails this on
  ``Mut,IVF16``; the port passes it, ``ROADMAP.md`` C8);
* serving: ``engine.mutate`` is atomic and retires cached answers, and a
  ``hot_swap`` under concurrent load drops no query.

Then parity with the reference: ``insert_batch`` graphs and the extended
code payloads bit-equal after the same insert stream, ``Mut`` directories
loading across packages with equal fingerprints, and a search over a
mutated index making no more host-to-device copies than one over a clean
index (the tombstone mask lives on the index's device).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from threadpoolctl import threadpool_limits  # noqa: E402

import jax  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.search import hnsw as jax_hnsw  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.factory import parse_index_spec  # noqa: E402
from repro_torch.core.theory import DriftTracker  # noqa: E402
from repro_torch.kernels.common import NEG_INF, PAD_ID  # noqa: E402
from repro_torch.kernels.graph_beam.ref import graph_beam_ref  # noqa: E402
from repro_torch.kernels.l2_topk.ref import l2_topk_ref  # noqa: E402
from repro_torch.search import hnsw as hnsw_lib  # noqa: E402
from repro_torch.search import ivf as ivf_lib  # noqa: E402
from repro_torch.serve import SearchEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's BLAS on one thread, as torch's: the fits here are numpy
    SVDs and eigensolvers, and several test workers share the cores."""
    with threadpool_limits(1):
        yield

N, DIM, K = 200, 16, 10

#: (spec, exact): exact tiers must self-hit at top-1; quantized tiers get
#: top-8 slack (codes can collide on an integer corpus)
SPECS = [
    ("Mut,Flat", True),
    ("Mut,IVF16", True),
    ("Mut,HNSW8", True),
    ("Mut,Shard2,Flat", True),
    ("Mut,SQ8", False),
    ("Mut,PQ4x4", False),
    ("Mut,IVF16,SQ8", False),
    ("Mut,IVF16,PQ4x4", False),
    ("Mut,HNSW8,SQ8", False),
]
SPEC_IDS = [s for s, _ in SPECS]


def _int_rows(seed: int, n: int, dim: int = DIM) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (n, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _int_rows(0, N)


def _kw(spec):
    return {"ef_construction": 40} if "HNSW" in spec else None


def _build(spec: str, corpus: np.ndarray) -> api.MutableIndex:
    ix = api.index_factory(spec, index_kw=_kw(spec), device="cpu")
    return ix.build(corpus)


# ---------------------------------------------------------------------------
# factory grammar
# ---------------------------------------------------------------------------
def test_mut_spec_roundtrip():
    for spec in ("Mut,Flat", "Mut,RAE8,IVF16,Rerank4", "Mut,HNSW8,SQ8"):
        assert str(parse_index_spec(spec)) == spec
    assert parse_index_spec("Mut,Flat").mutable
    assert not parse_index_spec("Flat").mutable


def test_mut_spec_errors():
    for bad in ("IVF16,Mut", "Mut,Mut,Flat", "Mut"):
        with pytest.raises(ValueError):
            parse_index_spec(bad)


def test_factory_returns_mutable_wrapper(corpus):
    ix = _build("Mut,Flat", corpus)
    assert isinstance(ix, api.MutableIndex)
    assert ix.ntotal == N
    # sharded children are not re-wrapped: one mutation owner
    sh = _build("Mut,Shard2,Flat", corpus)
    assert isinstance(sh, api.MutableIndex)
    assert not isinstance(sh._inner._shards[0], api.MutableIndex)


# ---------------------------------------------------------------------------
# insert immediacy + tombstone exactness, every tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,exact", SPECS, ids=SPEC_IDS)
def test_insert_visible_immediately(spec, exact, corpus):
    ix = _build(spec, corpus)
    new = _int_rows(7, 8)
    ext = ix.add(new)
    assert np.array_equal(ext, np.arange(N, N + 8))
    assert ix.ntotal == N + 8
    assert ix.epoch >= 1
    r = ix.search(new, 8)
    for row, eid in enumerate(ext):
        got = np.asarray(r.indices)[row]
        if exact:
            assert got[0] == eid, f"{spec}: row {row} top-1 {got[0]}"
        else:
            assert eid in got, f"{spec}: row {row} not in top-8 {got}"


@pytest.mark.parametrize("spec,exact", SPECS, ids=SPEC_IDS)
def test_delete_never_surfaces(spec, exact, corpus):
    ix = _build(spec, corpus)
    rng = np.random.default_rng(3)
    dead = np.sort(rng.choice(N, 20, replace=False)).astype(np.int64)
    assert ix.delete(dead) == 20
    assert ix.ntotal == N - 20
    # adversarial queries: the tombstoned vectors themselves
    r = ix.search(corpus[dead], K)
    idx = np.asarray(r.indices)
    assert not np.isin(idx, dead).any(), \
        f"{spec}: tombstoned id surfaced: {idx[np.isin(idx, dead)]}"
    assert (idx >= 0).all()


def test_delete_all_but_a_few_pads_result(corpus):
    ix = _build("Mut,Flat", corpus)
    keep = np.array([4, 9, 44], np.int64)
    dead = np.setdiff1d(np.arange(N, dtype=np.int64), keep)
    assert ix.delete(dead) == N - 3
    assert ix.ntotal == 3
    idx = np.asarray(ix.search(corpus[:5], K).indices)
    assert idx.shape == (5, 3)           # k clamps to the alive count
    assert np.isin(idx, keep).all()


def test_delete_everything_returns_empty(corpus):
    ix = _build("Mut,Flat", corpus)
    ix.delete(np.arange(N))
    r = ix.search(corpus[:4], K)
    assert np.asarray(r.indices).shape == (4, 0)
    assert np.asarray(r.scores).shape == (4, 0)


def test_delete_unknown_raises_redelete_noop(corpus):
    ix = _build("Mut,Flat", corpus)
    with pytest.raises(KeyError):
        ix.delete([N + 5])
    assert ix.delete([3, 5]) == 2
    epoch = ix.epoch
    assert ix.delete([3, 5]) == 0          # re-delete: no-op...
    assert ix.epoch == epoch               # ...and no identity churn
    with pytest.raises(ValueError):
        ix.search(corpus[:1], K, alive=np.ones(N, bool))  # mask is owned


# ---------------------------------------------------------------------------
# identity: epoch + fingerprint move on every mutation
# ---------------------------------------------------------------------------
def test_fingerprint_moves_on_every_mutation(corpus):
    ix = _build("Mut,Flat", corpus)
    prints = {ix.fingerprint()}
    ix.add(_int_rows(11, 2))
    prints.add(ix.fingerprint())
    ix.delete([0])
    prints.add(ix.fingerprint())
    ix.rebuild()
    prints.add(ix.fingerprint())
    assert len(prints) == 4, "a mutation failed to move the fingerprint"
    assert ix.epoch == 3 and ix.n_rebuilds == 1


@pytest.fixture
def ref_draws(monkeypatch):
    """The port's k-means seeds from the reference's draws, so every IVF
    build and rebuild is the reference's (its cells, its probed lists)."""
    def draw(n, n_clusters, seed):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                          (n_clusters,), replace=False))

    monkeypatch.setattr(ivf_lib, "init_rows", draw)


@pytest.mark.parametrize("spec", ["Mut,IVF16", "Mut,IVF16,SQ8",
                                  "Mut,IVF16,PQ4x4"])
def test_ids_stable_across_rebuild(spec, corpus, ref_draws):
    """The reference's test, which it fails on ``Mut,IVF16`` (tied rows
    come back in slab order, and ``rebuild`` re-lays the slab): the port's
    probes rank ties by row, so ids survive the compaction (C8). The
    k-means draws are the reference's: the rebuild re-clusters, and with
    other cells another probed set would answer (an approximate tier's
    recall, not the tie order this test pins)."""
    ix = _build(spec, corpus)
    ext = ix.add(_int_rows(13, 4))
    ix.delete(np.arange(0, 60, 2))
    before = np.asarray(ix.search(corpus[1:2], K).indices)
    ix.rebuild()
    assert ix.mutation_stats()["tombstones"] == 0.0
    after = np.asarray(ix.search(corpus[1:2], K).indices)
    if spec == "Mut,IVF16":
        assert np.array_equal(before, after), \
            "compaction renamed external ids"
        r = ix.search(_int_rows(13, 4), 1)
        assert np.array_equal(np.asarray(r.indices)[:, 0], ext)
    else:
        # re-trained codes may move rows; ties still go to the lower id
        s = np.asarray(ix.search(corpus[1:2], K).scores)[0]
        for j in range(K - 1):
            if s[j] == s[j + 1]:
                assert after[0, j] < after[0, j + 1]


def test_reference_fails_what_the_port_passes_c8(corpus, ref_draws):
    """The reference's own failure, kept in view: on ``Mut,IVF16`` its
    rebuild renames tied ids (the same rows, another order); the port,
    from the same draws, answers with the reference's rows in (score,
    id) order before and after."""
    ref = jax_api.index_factory("Mut,IVF16").build(corpus)
    port = _build("Mut,IVF16", corpus)
    answers = []
    for ix in (ref, port):
        ix.add(_int_rows(13, 4))
        ix.delete(np.arange(0, 60, 2))
        before = ix.search(corpus[1:2], K)
        ix.rebuild()
        answers.append((before, ix.search(corpus[1:2], K)))
    (rb, ra), (pb, pa) = answers
    assert not np.array_equal(rb.indices, ra.indices)
    assert sorted(rb.indices[0].tolist()) == sorted(ra.indices[0].tolist())
    for got in (pb, pa):
        assert sorted(got.indices[0].tolist()) == sorted(
            rb.indices[0].tolist())
        np.testing.assert_array_equal(got.scores, np.asarray(rb.scores))
        order = np.lexsort((got.indices[0], -got.scores[0]))
        np.testing.assert_array_equal(order, np.arange(K))


def test_imbalance_triggers_ivf_rebuild(corpus):
    ix = api.MutableIndex(api.IVFFlatIndex(n_cells=8, kmeans_iters=4,
                                           device="cpu"),
                          imbalance_trigger=2.5)
    ix.build(corpus)
    assert ix.n_rebuilds == 0
    hot = np.tile(corpus[0], (120, 1)) + _int_rows(17, 120) * 0.25
    ix.add(hot.astype(np.float32))
    assert ix.n_rebuilds >= 1, \
        f"imbalance {ix._imbalance():.2f} never tripped a re-cluster"
    assert np.asarray(ix.search(corpus[5:6], 1).indices)[0, 0] == 5


def test_hnsw_entry_reassigned_when_tombstoned(corpus):
    ix = _build("Mut,HNSW8", corpus)
    g = ix._graph_index()._g
    entry_ext = int(ix._row_ids[g.entry])
    ix.delete([entry_ext])
    assert ix._alive[g.entry], "entry still points at a tombstone"
    r = ix.search(corpus[2:3], K)
    assert np.asarray(r.indices)[0, 0] == 2
    assert entry_ext not in np.asarray(r.indices)
    # the batched engine too (the mask stays on the index's device)
    r = ix.search(corpus[2:6], K)
    assert np.asarray(r.indices)[0, 0] == 2
    assert entry_ext not in np.asarray(r.indices)


# ---------------------------------------------------------------------------
# re-pack neutrality (the HNSW insert/pack contract)
# ---------------------------------------------------------------------------
def test_compact_pads_bitwise_neutral_without_holes():
    rng = np.random.default_rng(5)
    links0 = rng.integers(0, 50, (12, 8)).astype(np.int32)
    links0[:6, 5:] = -1
    holey = links0.copy()
    holey[8, [1, 4]] = -1
    dense_before = holey[:8].copy()
    hnsw_lib._compact_pads(holey, np.empty((0, 12, 4), np.int32))
    assert np.array_equal(holey[:8], dense_before)
    row = holey[8]
    assert (row[-2:] == -1).all() and (row[:-2] >= 0).all()
    want = [x for j, x in enumerate(links0[8]) if j not in (1, 4)]
    assert row[:-2].tolist() == want


def test_insert_batch_only_touches_neighbor_rows(corpus):
    g = hnsw_lib.build(corpus, M=8, ef_construction=40, seed=0)
    before0 = g.links0.copy()
    new_ids = hnsw_lib.insert_batch(g, _int_rows(19, 6),
                                    ef_construction=40, seed=0,
                                    device="cpu")
    assert np.array_equal(new_ids, np.arange(N, N + 6))
    changed = np.flatnonzero((g.links0[:N] != before0).any(axis=1))
    assert 0 < changed.size < N // 2
    assert g.packed is None, "insert must invalidate the packed cache"
    g.pack()
    untouched = ~np.isin(np.arange(N), changed)
    assert np.array_equal(g.packed.nbrs0[:N][untouched], before0[untouched])


# ---------------------------------------------------------------------------
# kernel db_mask semantics (the operand the alive mask lowers into)
# ---------------------------------------------------------------------------
def test_l2_topk_ref_mask_semantics(corpus):
    q, db = torch.from_numpy(corpus[:6]), torch.from_numpy(corpus)
    mask = np.ones(N, bool)
    mask[::3] = False
    vals, idx = l2_topk_ref(q, db, K, db_mask=torch.from_numpy(mask))
    idx = idx.numpy()
    assert not np.isin(idx, np.flatnonzero(~mask)).any()
    alive_rows = np.flatnonzero(mask)
    d = ((corpus[:6, None, :] - corpus[None, alive_rows, :]) ** 2).sum(-1)
    assert np.array_equal(-vals.numpy(), np.sort(d, axis=1)[:, :K])
    v0, i0 = l2_topk_ref(q, db, K)
    v1, i1 = l2_topk_ref(q, db, K, db_mask=torch.ones(N, dtype=torch.bool))
    assert torch.equal(v0, v1) and torch.equal(i0, i1)


def test_l2_topk_ref_mask_pads_when_starved():
    db = np.arange(8, dtype=np.float32)[:, None] * np.ones((8, 4),
                                                           np.float32)
    mask = np.zeros(8, bool)
    mask[2] = True
    vals, idx = l2_topk_ref(torch.from_numpy(db[:1]), torch.from_numpy(db),
                            4, db_mask=torch.from_numpy(mask))
    idx, vals = idx.numpy(), vals.numpy()
    assert idx[0, 0] == 2 and (idx[0, 1:] == PAD_ID).all()
    assert (vals[0, 1:] <= NEG_INF / 2).all()


def test_graph_beam_ref_mask_equals_slot_masking(corpus):
    rng = np.random.default_rng(23)
    q = torch.from_numpy(corpus[:4])
    db = torch.from_numpy(corpus)
    nbr = rng.integers(0, N, (4, 8)).astype(np.int32)
    beam_v = torch.full((4, 6), NEG_INF)
    beam_i = torch.full((4, 6), -1, dtype=torch.int32)
    mask = np.ones(N, bool)
    mask[nbr[0, 2]] = False
    mask[nbr[3, 5]] = False
    got_v, got_i = graph_beam_ref(q, db, torch.from_numpy(nbr), beam_v,
                                  beam_i, db_mask=torch.from_numpy(mask))
    nbr2 = np.where(mask[np.where(nbr >= 0, nbr, 0)] | (nbr < 0), nbr, -1)
    want_v, want_i = graph_beam_ref(q, db, torch.from_numpy(nbr2), beam_v,
                                    beam_i)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert not np.isin(got_i.numpy(), [nbr[0, 2], nbr[3, 5]]).any()


def test_alive_none_is_the_static_path(corpus):
    flat = api.FlatIndex(device="cpu").build(corpus)
    r0 = flat.search(corpus[:8], K)
    r1 = flat.search(corpus[:8], K, alive=np.ones(N, bool))
    r2 = flat.search(corpus[:8], K, alive=torch.ones(N, dtype=torch.bool))
    for r in (r1, r2):
        assert np.array_equal(r0.indices, r.indices)
        assert np.array_equal(r0.scores, r.scores)


# ---------------------------------------------------------------------------
# drift monitor (Eq. 15 band) + reducer retrain policy
# ---------------------------------------------------------------------------
def test_drift_tracker_band_and_trigger():
    w = 2.0 * np.eye(4, 8, dtype=np.float32)
    t = DriftTracker.from_weights(torch.from_numpy(w), tol=0.1,
                                  threshold=0.2, min_observed=16)
    assert t.sigma_min == pytest.approx(2.0) == t.sigma_max
    xs = np.zeros((32, 8), np.float32)
    xs[:, :4] = _int_rows(29, 32, 4) + 0.5
    assert t.observe(xs, 2.0 * xs[:, :4]) == 0.0
    assert not t.should_retrain
    assert t.observe(xs, 5.0 * xs[:, :4]) == 1.0
    assert t.observed == 64 and t.violation_rate == pytest.approx(0.5)
    assert t.should_retrain
    t.reset()
    assert t.observed == 0 and not t.should_retrain


def test_drift_tracker_skips_zero_norm_rows():
    t = DriftTracker(sigma_min=1.0, sigma_max=1.0, tol=0.5)
    xs = np.zeros((4, 3), np.float32)
    xs[0] = 1.0
    assert t.observe(xs, xs) == 0.0
    assert t.observed == 1


def test_drift_retrain_swaps_reducer_and_index_together():
    rng = np.random.default_rng(31)
    data = rng.standard_normal((160, DIM)).astype(np.float32)
    ix = api.index_factory("Mut,RAE8,Flat",
                           reducer_kw={"steps": 200, "seed": 0},
                           device="cpu")
    ix.build(data)
    assert ix._drift is not None, "RAE stack must arm the Eq. 15 monitor"
    old_params = ix._inner.reducer.params_
    old_fp = ix._inner.reducer.fingerprint()
    ix._drift.observed, ix._drift.violations = 500, 400   # force the trip
    ix.add(data[:1] * 3.0)
    assert ix.n_reducer_retrains == 1
    assert ix._inner.reducer.params_ is not None
    assert ix._inner.reducer.params_ is not old_params
    assert ix._inner.reducer.fingerprint() != old_fp
    assert ix._drift.observed == 0
    assert np.asarray(ix.search(data[5:6], 1).indices)[0, 0] == 5


def test_drift_monitor_counts_like_the_reference():
    """The same stream of adds, the same monitor counts: the port takes
    the norms on the index's device and hands the monitor two [b] vectors;
    the reference hands it the encoded rows."""
    rng = np.random.default_rng(8)
    data = rng.standard_normal((160, DIM)).astype(np.float32)
    port = api.index_factory("Mut,RAE8,Flat", reducer_kw={"steps": 50},
                             device="cpu").build(data)
    ref = jax_api.index_factory("Mut,RAE8,Flat", reducer_kw={"steps": 50})
    ref._inner.reducer.params_ = {
        k: jax.numpy.asarray(v.numpy())
        for k, v in port._inner.reducer.params_.items()}
    ref._inner.reducer.cfg_ = jax_api.make_reducer(
        "rae", 8)._make_cfg(DIM)
    ref.build(data)
    for b, scale in ((16, 1.0), (24, 6.0), (8, 0.05)):
        rows = rng.standard_normal((b, DIM)).astype(np.float32) * scale
        port.add(rows)
        ref.add(rows)
        assert (port._drift.observed, port._drift.violations) == (
            ref._drift.observed, ref._drift.violations)
        assert port.n_reducer_retrains == ref.n_reducer_retrains == 0


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------
def test_save_load_roundtrip_keeps_tombstones(tmp_path, corpus):
    ix = _build("Mut,IVF16", corpus)
    ix.add(_int_rows(37, 3))
    ix.delete([7, 8])
    ix.save(str(tmp_path / "mut"))
    back = api.load_index(str(tmp_path / "mut"), device="cpu")
    assert isinstance(back, api.MutableIndex)
    assert back.fingerprint() == ix.fingerprint()
    assert back.epoch == ix.epoch and back.ntotal == ix.ntotal
    r = back.search(corpus[7:9], K)
    assert not np.isin(np.asarray(r.indices), [7, 8]).any()
    back.delete([9])
    assert back.ntotal == ix.ntotal - 1


@pytest.mark.parametrize("spec", ["Mut,IVF16", "Mut,HNSW8,SQ8",
                                  "Mut,RAE8,Flat,Rerank2"])
def test_reference_saved_mut_directory_loads(spec, corpus, tmp_path):
    kw = {"reducer_kw": {"steps": 20}} if "RAE" in spec else {}
    ref = jax_api.index_factory(spec, index_kw=_kw(spec), **kw).build(corpus)
    ref.add(_int_rows(41, 5))
    ref.delete([3, 11, N + 1])
    ref.save(str(tmp_path / "r"))
    port = api.load_index(str(tmp_path / "r"), device="cpu")
    assert isinstance(port, api.MutableIndex)
    assert port.fingerprint() == ref.fingerprint()
    assert (port.epoch, port.ntotal, port._next_id) == (
        ref.epoch, ref.ntotal, ref._next_id)
    r = port.search(corpus[[3, 11, 12]], K)
    assert not np.isin(r.indices, [3, 11, N + 1]).any()
    port.save(str(tmp_path / "p"))
    assert jax_api.load_index(str(tmp_path / "p")).fingerprint() \
        == ref.fingerprint()


# ---------------------------------------------------------------------------
# the graph insert against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", [None, "sq8", "pq"])
def test_insert_batch_graph_and_codes_bit_equal(codec, corpus):
    """The same corpus, seed and stream of insert batches give the
    reference's graph bit for bit (levels, links0, links, entry), and the
    code payload, extended with the trained codec, the reference's codes
    and node biases."""
    ref = jax_hnsw.build(corpus, M=4, ef_construction=30, seed=2)
    got = hnsw_lib.build(corpus, M=4, ef_construction=30, seed=2)
    if codec is not None:
        rc = jax_hnsw.make_graph_codes(ref.vecs, codec, m=4, bits=4)
        ref.codec = rc
        got.codec = hnsw_lib.GraphCodes(
            kind=codec, codes=np.array(rc.codes),
            node_bias=np.array(rc.node_bias),
            vmin=None if rc.vmin is None else np.array(rc.vmin),
            step=None if rc.step is None else np.array(rc.step),
            codebooks=None if rc.codebooks is None
            else np.array(rc.codebooks))
    for b, (seed, n) in enumerate(((41, 1), (42, 37), (43, 90))):
        rows = _int_rows(seed, n)
        np.testing.assert_array_equal(
            hnsw_lib.insert_batch(got, rows, ef_construction=30, seed=2,
                                  device="cpu"),
            jax_hnsw.insert_batch(ref, rows, ef_construction=30, seed=2))
        for name in ("vecs", "levels", "links0", "links"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=f"{name} after batch {b}")
        assert got.entry == ref.entry and got.packed is None
        if codec is not None:
            np.testing.assert_array_equal(got.codec.codes,
                                          np.asarray(ref.codec.codes))
            np.testing.assert_array_equal(got.codec.node_bias,
                                          np.asarray(ref.codec.node_bias))
            assert got.codec.codes.dtype == np.uint8
            assert got.codec._dev == {}


@pytest.mark.parametrize("spec", ["Mut,HNSW8", "Mut,HNSW8,SQ8"])
def test_mut_graph_stack_is_the_reference_s(spec, corpus):
    """Through the API: the same adds and deletes give the reference's
    fingerprint (graph, codes, epoch, mask, ids), and the same answers."""
    ref = jax_api.index_factory(spec, index_kw=_kw(spec)).build(corpus)
    port = _build(spec, corpus)
    for ix in (ref, port):
        ix.add(_int_rows(47, 12))
        ix.delete([1, 2, N + 3])
        ix.add(_int_rows(48, 3))
    assert port.fingerprint() == ref.fingerprint()
    q = np.concatenate([corpus[4:8], _int_rows(47, 12)[:4]])
    got, want = port.search(q, K), ref.search(q, K)
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores))


# ---------------------------------------------------------------------------
# the mask stays on the device
# ---------------------------------------------------------------------------
def _count_uploads(monkeypatch):
    """Count tensors made from host arrays (numpy or lists): on a CUDA
    index each is a host-to-device copy."""
    calls = {"n": 0}
    for name in ("as_tensor", "tensor", "from_numpy"):
        orig = getattr(torch, name)

        def wrapped(data, *a, _orig=orig, **kw):
            if not isinstance(data, torch.Tensor):
                calls["n"] += 1
            return _orig(data, *a, **kw)

        monkeypatch.setattr(torch, name, wrapped)
    return calls


@pytest.mark.parametrize("spec", ["Mut,Flat", "Mut,IVF16", "Mut,HNSW8",
                                  "Mut,Shard2,Flat", "Mut,IVF16,SQ8",
                                  "Mut,SQ8", "Mut,RAE8,IVF16,Rerank4"])
def test_masked_search_uploads_no_more_than_a_clean_one(spec, corpus,
                                                        monkeypatch):
    kw = {"reducer_kw": {"steps": 20}} if "RAE" in spec else {}
    clean = api.index_factory(spec, index_kw=_kw(spec), device="cpu",
                              **kw).build(corpus)
    mutated = api.index_factory(spec, index_kw=_kw(spec), device="cpu",
                                **kw).build(corpus)
    mutated.delete([5, 6, 7, 100])
    q = corpus[10:18]
    calls = _count_uploads(monkeypatch)
    clean.search(q, K)
    n_clean = calls["n"]
    calls["n"] = 0
    r = mutated.search(q, K)
    assert calls["n"] <= n_clean, (calls["n"], n_clean)
    assert not np.isin(r.indices, [5, 6, 7, 100]).any()


# ---------------------------------------------------------------------------
# serving: atomic mutation + zero-downtime swap
# ---------------------------------------------------------------------------
def test_engine_mutate_is_atomic_and_retires_cache(corpus):
    ix = _build("Mut,Flat", corpus)
    with SearchEngine(ix, max_batch=8, max_wait_ms=2.0,
                      cache_size=32) as eng:
        assert eng.search_one(corpus[5], K).indices[0, 0] == 5
        assert eng.search_one(corpus[5], K).indices[0, 0] == 5  # cached
        assert eng.mutate(lambda i: i.delete([5])) == 1
        after = eng.search_one(corpus[5], K)    # same key, new epoch
        assert 5 not in after.indices
        ext = eng.mutate(lambda i: i.add(_int_rows(41, 2)))
        assert np.array_equal(ext, [N, N + 1])  # mutate returns fn's result
        st = eng.stats()["mutation"]
        assert st["mutations"] == 2
        assert st["index"]["epoch"] == 2.0 and st["index"]["deleted"] == 1.0


def test_hot_swap_under_concurrent_load_drops_nothing(corpus):
    """Clients hammer their own rows while the index is swapped for a
    superset rebuild: every reply must be the exact self-hit (entirely
    old or entirely new index, never a torn read), none dropped."""
    flat = api.FlatIndex(device="cpu").build(corpus)
    bigger = np.concatenate([corpus, _int_rows(43, 16)])
    n_clients, reps = 12, 6
    out = [[None] * reps for _ in range(n_clients)]
    start = threading.Barrier(n_clients + 1)

    def client(i):
        start.wait()
        for j in range(reps):
            out[i][j] = eng.search_one(corpus[i], K)

    with SearchEngine(flat, max_batch=8, max_wait_ms=2.0,
                      cache_size=0) as eng:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        start.wait()
        promoted = eng.hot_swap(
            lambda: api.FlatIndex(device="cpu").build(bigger), ks=(K,))
        for t in threads:
            t.join()
        assert promoted is eng.index and eng.index.ntotal == N + 16
        st = eng.stats()
        assert st["mutation"]["swaps"] == 1
        assert st["requests"] == n_clients * reps
    for i in range(n_clients):
        for r in out[i]:
            assert r is not None, "a query was dropped during the swap"
            assert r.indices[0, 0] == i and r.scores[0, 0] == 0.0
