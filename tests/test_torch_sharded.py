"""Parity of the port's sharded tier (``repro_torch.distributed``,
``repro_torch.api.ShardedIndex``, the ``Shard<S>`` factory stage) with the
reference package, on the CPU.

The contract under test is the reference's (``docs/sharded_serving.md``):
sharded search is bitwise invariant to the shard count. Integer-valued f32
corpora make every score exact, so S in {1, 2, 8} must give the
``(scores, indices)`` of a ``FlatIndex`` over the whole corpus, ties (to
the lower global id) and ragged prime-sized corpora included, and the
reference's ``ShardedIndex`` must give the same bits. On the CPU the
port's merge runs the plain version of ``topk_merge``.

On float corpora through a reducer, ids must be equal and scores within
``rtol=1e-5, atol=1e-4`` (float32 sums taken in another order).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.distributed import partitioning as jax_part  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import FlatIndex, ShardedIndex  # noqa: E402
from repro_torch.distributed import (partition_ivf_cells,  # noqa: E402
                                     partition_rows)
from repro_torch.search import distributed as ds  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _int_corpus(n, d, seed=0):
    """Integer-valued f32: exact arithmetic, dense score ties."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, (n, d)).astype(np.float32)
    x[n // 2] = x[n // 3]  # planted duplicate rows -> guaranteed ties
    return x


def _queries(n, d, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (n, d)).astype(np.float32)


def _bits_equal(got, want):
    """Ids equal and scores equal bit for bit (the sign of zero too)."""
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_array_equal(
        np.asarray(got.scores, np.float32).view(np.int32),
        np.asarray(want.scores, np.float32).view(np.int32))


def _sharded(s, **kw):
    return ShardedIndex(n_shards=s, device="cpu", **kw)


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,s", [(101, 4), (509, 8), (7, 7), (5, 8), (0, 3)])
def test_partition_rows_disjoint_cover(n, s):
    parts = partition_rows(n, s)
    cat = np.concatenate(parts) if parts else np.empty(0, np.int32)
    np.testing.assert_array_equal(np.sort(cat), np.arange(n))
    sizes = [len(p) for p in parts]
    if sizes:
        assert max(sizes) - min(sizes) <= 1
    for p in parts:
        assert p.dtype == np.int32
        assert np.all(np.diff(p) > 0) if len(p) > 1 else True
    want = jax_part.partition_rows(n, s)
    assert len(parts) == len(want)
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a, b)


def test_partition_rows_rejects_bad_count():
    with pytest.raises(ValueError):
        partition_rows(10, 0)
    with pytest.raises(ValueError):
        partition_ivf_cells(_int_corpus(10, 4), 0)


@pytest.mark.parametrize("n,s,seed", [(101, 4, 3), (64, 8, 0), (150, 3, 11)])
def test_partition_ivf_cells_from_the_reference_init(n, s, seed):
    corpus = _int_corpus(n, 8)
    n_cells = min(8 * s, n)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        (n_cells,), replace=False))
    got = partition_ivf_cells(corpus, s, seed=seed, init=init)
    want = jax_part.partition_ivf_cells(corpus, s, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    cat = np.concatenate([p for p in got if len(p)])
    np.testing.assert_array_equal(np.sort(cat), np.arange(n))
    own = partition_ivf_cells(corpus, s, seed=seed)  # the port's own init
    np.testing.assert_array_equal(
        np.sort(np.concatenate([p for p in own if len(p)])), np.arange(n))
    for p in own:
        if len(p) > 1:
            assert np.all(np.diff(p) > 0)


# ---------------------------------------------------------------------------
# shard-count invariance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [101, 509])  # primes: every split is ragged
@pytest.mark.parametrize("s", [1, 2, 8])
def test_sharded_bitwise_matches_flat_and_the_reference(n, s):
    corpus = _int_corpus(n, 16)
    q = _queries(9, 16)
    flat = FlatIndex(device="cpu").build(corpus).search(q, 10)
    got = _sharded(s).build(corpus).search(q, 10)
    want = jax_api.ShardedIndex(n_shards=s).build(corpus).search(q, 10)
    np.testing.assert_array_equal(got.indices, flat.indices)
    np.testing.assert_array_equal(got.scores, flat.scores)
    _bits_equal(got, want)
    assert got.stats == want.stats


def test_sharded_invariant_across_shard_counts():
    corpus = _int_corpus(257, 12, seed=5)
    q = _queries(6, 12, seed=6)
    outs = [_sharded(s).build(corpus).search(q, 7) for s in (1, 2, 8)]
    for other in outs[1:]:
        _bits_equal(other, outs[0])


def test_ivf_partition_matches_flat():
    corpus = _int_corpus(150, 16, seed=7)
    q = _queries(5, 16, seed=8)
    ref = FlatIndex(device="cpu").build(corpus).search(q, 10)
    got = _sharded(4, partition="ivf", seed=11).build(corpus).search(q, 10)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.scores, ref.scores)


def test_ragged_tail_rows_are_searchable():
    corpus = _int_corpus(101, 16, seed=9)
    idx = _sharded(8).build(corpus)
    for row in (100, 97, 96):  # the 101 % 8 = 5 tail region and beyond
        r = idx.search(corpus[row:row + 1], 1)
        assert int(r.indices[0, 0]) == row


def test_k_larger_than_shard_size():
    corpus = _int_corpus(101, 8, seed=10)
    q = _queries(4, 8, seed=11)
    ref = FlatIndex(device="cpu").build(corpus).search(q, 50)
    got = _sharded(8).build(corpus).search(q, 50)  # 13 rows a shard
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.scores, ref.scores)


def test_k_larger_than_corpus():
    corpus = _int_corpus(11, 8, seed=12)
    got = _sharded(4).build(corpus).search(_queries(3, 8), 64)
    assert got.indices.shape == (3, 11)  # clamped to ntotal, no pad columns
    assert np.all(got.indices >= 0)


@pytest.mark.parametrize("child", ["Flat", "IVF8"])
def test_alive_tombstones_match_the_reference(child):
    corpus = _int_corpus(211, 8, seed=21)
    q = _queries(5, 8, seed=22)
    alive = np.random.default_rng(23).random(211) > 0.4
    got = _sharded(4, child_spec=child).build(corpus).search(q, 12,
                                                            alive=alive)
    want = jax_api.ShardedIndex(n_shards=4, child_spec=child).build(
        corpus).search(q, 12, alive=alive)
    if child == "Flat":  # exact children: the reference's bits
        _bits_equal(got, want)
    dead = np.flatnonzero(~alive)
    assert not np.isin(got.indices, dead).any()


def test_ivf_children_from_reference_dirs_answer_like_it(tmp_path):
    corpus = _int_corpus(307, 8, seed=24)
    q = _queries(7, 8, seed=25)
    ref = jax_api.ShardedIndex(n_shards=3, child_spec="IVF8").build(corpus)
    d = str(tmp_path / "sh")
    ref.save(d)
    port = api.load_index(d, device="cpu")
    assert isinstance(port, ShardedIndex) and port.shard_count == 3
    assert port.fingerprint() == ref.fingerprint()
    for params in (None, 12):
        got = port.search(q, 9, params=None if params is None
                          else api.SearchParams(nprobe=params))
        want = ref.search(q, 9, params=None if params is None
                          else jax_api.SearchParams(nprobe=params))
        _bits_equal(got, want)
        assert got.stats == want.stats
    port.set_params(api.SearchParams(nprobe=12))
    ref.set_params(jax_api.SearchParams(nprobe=12))
    assert all(c.nprobe == 12 for c in port._shards)
    assert port.fingerprint() == ref.fingerprint()


# ---------------------------------------------------------------------------
# factory grammar
# ---------------------------------------------------------------------------
def test_factory_parse_shard_round_trip():
    for s in ("Shard8,Flat", "RAE64,Shard8,IVF256,Rerank4",
              "PCA8,Shard4,IVF16,Rerank2", "Shard2,Flat,SQ8"):
        assert str(api.parse_index_spec(s)) == s
        assert api.parse_index_spec(s) == _as_port(jax_api.parse_index_spec(s))
    assert str(api.parse_index_spec("Shard8")) == "Shard8,Flat"
    assert api.parse_index_spec("Shard8").shards == 8


def _as_port(spec):
    import dataclasses

    return api.IndexSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("bad", ["Shard", "Shard0", "Flat,Shard2",
                                 "Shard2,Shard4", "Shard2,RAE8,Flat"])
def test_factory_rejects_bad_shard_specs(bad):
    with pytest.raises(ValueError):
        api.parse_index_spec(bad)


@pytest.mark.parametrize("spec,child,base", [
    ("Shard2", "Flat", api.FlatIndex), ("Shard3,IVF8", "IVF8",
                                        api.IVFFlatIndex),
    ("Shard2,HNSW8", "HNSW8", api.HNSWIndex),
])
def test_factory_builds_sharded_children(spec, child, base):
    corpus = _int_corpus(120, 8, seed=26)
    idx = api.index_factory(spec, device="cpu")
    assert isinstance(idx, ShardedIndex) and idx.child_spec == child
    idx.build(corpus)
    assert all(isinstance(c, base) for c in idx._shards)
    r = idx.search(_queries(4, 8, seed=27), 5)
    assert r.indices.shape == (4, 5) and np.all(r.indices >= 0)
    assert r.stats["shards"] == float(idx.shard_count)


def test_factory_builds_sharded_stack():
    corpus = _int_corpus(220, 16, seed=13)
    q = _queries(5, 16, seed=14)
    idx = api.index_factory("RAE8,Shard4,IVF16,Rerank2",
                            reducer_kw={"steps": 20}, device="cpu")
    idx.build(corpus)
    base = idx.base
    assert isinstance(base, ShardedIndex) and base.shard_count == 4
    r = idx.search(q, 5)
    assert r.indices.shape == (5, 5) and np.all(r.indices >= 0)
    assert base.build_times["partition_s"] >= 0
    assert len(base.build_times["children_s"]) == 4


def test_sharded_rejects_nested_wrappers_in_child_spec():
    with pytest.raises(ValueError):
        _sharded(2, child_spec="Shard2,Flat").build(_int_corpus(20, 4))
    with pytest.raises(ValueError):
        _sharded(2, child_spec="RAE4,Flat").build(_int_corpus(20, 4))


def test_mesh_workers_say_why_they_are_not_ported():
    with pytest.raises(NotImplementedError, match="4-chip cell"):
        _sharded(2, workers="mesh").build(_int_corpus(20, 4))
    with pytest.raises(NotImplementedError, match="4-chip cell"):
        ds.search(torch.zeros((1, 2)), torch.zeros((3, 2)), 1, mesh=object())
    with pytest.raises(ValueError):
        _sharded(2, workers="gpus")


# ---------------------------------------------------------------------------
# persistence + fingerprint
# ---------------------------------------------------------------------------
def test_save_load_fingerprint_round_trip(tmp_path):
    corpus = _int_corpus(101, 8, seed=15)
    q = _queries(4, 8, seed=16)
    idx = _sharded(3, child_spec="IVF4").build(corpus)
    d = os.path.join(str(tmp_path), "idx")
    idx.save(d)
    idx2 = api.load_index(d, device="cpu")
    assert idx2.fingerprint() == idx.fingerprint()
    _bits_equal(idx2.search(q, 5), idx.search(q, 5))
    ref = jax_api.load_index(d)  # the reference reads the port's layout
    assert ref.fingerprint() == idx.fingerprint()
    _bits_equal(idx.search(q, 5), ref.search(q, 5))


def test_fingerprint_sensitive_to_sharding():
    corpus = _int_corpus(60, 8, seed=17)
    a = _sharded(2).build(corpus)
    b = _sharded(3).build(corpus)
    c = _sharded(2).build(_int_corpus(60, 8, seed=18))
    assert a.fingerprint() != b.fingerprint()
    assert a.fingerprint() != c.fingerprint()
    assert a.fingerprint() == jax_api.ShardedIndex(n_shards=2).build(
        corpus).fingerprint()


def test_reference_saved_two_stage_sharded_ivf_stack(tmp_path):
    from repro.data import synthetic as jax_synthetic

    corpus = jax_synthetic.embedding_corpus(600, 32, n_clusters=4,
                                            intrinsic=8, seed=3)
    rng = np.random.default_rng(4)
    q = corpus[rng.integers(0, 600, 8)] + 0.01 * rng.standard_normal(
        (8, 32)).astype(np.float32)
    ref = jax_api.index_factory("RAE8,Shard2,IVF32,Rerank2",
                                reducer_kw={"steps": 30}).build(corpus)
    d = str(tmp_path / "stack")
    ref.save(d)
    port = api.load_index(d, device="cpu")
    assert isinstance(port.base, ShardedIndex)
    assert all(isinstance(c, api.IVFFlatIndex) for c in port.base._shards)
    assert port.fingerprint() == ref.fingerprint()
    got, want = port.search(q, 5), ref.search(q, 5)
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=RTOL, atol=ATOL)
    assert got.stats["shards"] == want.stats["shards"] == 2.0


# ---------------------------------------------------------------------------
# ROADMAP C9: the Shard stack built from all of the reference's draws
# ---------------------------------------------------------------------------
def test_shard_stack_from_the_reference_draws_is_the_reference_stack_c9(
        monkeypatch):
    """C9 (the 20k Shard8 acceptance recall of the port's own draws, 0.8984
    against the reference's 0.9078) is the draws, not the port: from the
    reference's RAE init (``convert.params_from_jax``) and its k-means init
    rows, every part of ``RAE16,Shard4,IVF16,Rerank4`` agrees with the
    reference's, part by part: W_e and the reduced corpus (float32 sums of
    200 Adam steps in another order: atol 1e-6), each shard's rows, its
    centroids (atol 1e-5) and its lists (equal), the stage-1 ids and the
    reranked ids (equal), and so the recall. (The 20k x 256 Shard8 stack
    built the same way gets 0.9078 in both.)"""
    from repro.configs.base import RAEConfig as JaxRAECfg
    from repro.core import rae as jax_rae
    from repro_torch.convert import params_from_jax
    from repro_torch.core import trainer
    from repro_torch.data import embedding_corpus
    from repro_torch.search import ivf

    spec = "RAE16,Shard4,IVF16,Rerank4"
    corpus = embedding_corpus(4000, 64, n_clusters=8, intrinsic=16, seed=3)
    rng = np.random.default_rng(5)
    queries = corpus[rng.integers(0, 4000, 32)] \
        + 0.01 * rng.standard_normal((32, 64)).astype(np.float32)
    kw = {"steps": 200, "seed": 0}
    want = jax_api.index_factory(spec, reducer_kw=kw).build(corpus)
    want_res = want.search(queries, 10)

    monkeypatch.setattr(ivf, "init_rows", lambda n, c, seed: np.asarray(
        jax.random.choice(jax.random.PRNGKey(seed), n, (c,), replace=False)))
    got = api.index_factory(spec, reducer_kw=kw, device="cpu")
    red = got.reducer
    cfg = red._make_cfg(64)
    jinit = jax_rae.init(JaxRAECfg(**{f: getattr(cfg, f)
                                      for f in cfg.__dataclass_fields__}),
                         jax.random.PRNGKey(cfg.seed))
    res = trainer.train(cfg, corpus, log_every=10 ** 9, device="cpu",
                        init_params=params_from_jax(
                            {k: np.asarray(v) for k, v in jinit.items()},
                            "cpu"))
    red.params_, red.cfg_ = res.params, cfg
    got.build(corpus)
    got_res = got.search(queries, 10)

    np.testing.assert_allclose(red.params_["w_e"].numpy(),
                               np.asarray(want.reducer.params_["w_e"]),
                               atol=1e-6)
    np.testing.assert_allclose(red.transform(corpus).numpy(),
                               np.asarray(want.reducer.transform(corpus)),
                               atol=1e-5)
    assert len(got.base._shards) == len(want.base._shards) == 4
    for s, (a, b) in enumerate(zip(got.base._shards, want.base._shards)):
        np.testing.assert_array_equal(got.base._row_maps[s],
                                      want.base._row_maps[s])
        np.testing.assert_allclose(a._ivf.centroids.numpy(),
                                   np.asarray(b._ivf.centroids), atol=1e-5)
        np.testing.assert_array_equal(a._ivf.lists.numpy(),
                                      np.asarray(b._ivf.lists))
    k1 = got.stage1_k(10)
    s1 = got.base.search(red.transform(queries), k1)
    s1_ref = want.base.search(np.asarray(want.reducer.transform(queries)), k1)
    np.testing.assert_array_equal(s1.indices, np.asarray(s1_ref.indices))
    np.testing.assert_array_equal(got_res.indices,
                                  np.asarray(want_res.indices))
    np.testing.assert_allclose(got_res.scores, np.asarray(want_res.scores),
                               rtol=RTOL, atol=ATOL)
