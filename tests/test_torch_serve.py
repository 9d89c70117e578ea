"""The port's serving engine (``repro_torch.serve``), on the CPU.

The 29 tests of the reference's ``tests/test_serve.py``, mirrored on the
port with the same corpus (N, DIM, K = 512, 32, 5; small random integers
cast to float32, so every distance is exact and a coalesced row must equal
its lone answer bit for bit): the LRU cache, the pow2 buckets, scheduler
parity (ids and score bits), flush timing, mixed k, the cache's
fingerprint keying, the stats surface, warm-up and the HTTP front end
(200s, 400s for a bad k, a wrong dim, the wrong field and NaN / Inf).

Then parity with the reference on the same numpy inputs: the port's engine
and the reference's give the same answers, bit for bit, over the same
Flat and IVF builds (the IVF build is the reference's, saved and loaded by
the port: equal fingerprints), and the same stats keys; a NaN or wrong-dim
HTTP request leaves the cache as it was.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.serve import SearchEngine as JaxEngine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.serve import (LRUCache, SearchEngine,  # noqa: E402
                               start_http_server)
from repro_torch.serve.engine import _buckets, _Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N, DIM, K = 512, 32, 5


def _int_corpus(seed: int, n: int = N, dim: int = DIM) -> np.ndarray:
    """Integer-valued f32 vectors: exact arithmetic, so batched and
    per-query scans agree bitwise. Rows are distinct w.p. ~1."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (n, dim)).astype(np.float32)


def _flat(corpus):
    return api.FlatIndex(device="cpu").build(corpus)


@pytest.fixture(scope="module")
def corpus():
    return _int_corpus(0)


@pytest.fixture(scope="module")
def flat(corpus):
    return _flat(corpus)


@pytest.fixture()
def engine(flat):
    eng = SearchEngine(flat, max_batch=8, max_wait_ms=5.0, cache_size=64)
    with eng:
        yield eng


# ---------------------------------------------------------------------------
# LRU cache unit
# ---------------------------------------------------------------------------
def test_lru_eviction_order():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1      # refresh a
    c.put("c", 3)               # evicts b (LRU)
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    s = c.stats()
    assert s["size"] == 2 and s["hits"] == 3 and s["misses"] == 1


def test_lru_size_zero_disables():
    c = LRUCache(0)
    c.put("a", 1)
    assert c.get("a") is None and len(c) == 0


def test_buckets_cover_max_batch():
    assert _buckets(32) == [1, 2, 4, 8, 16, 32]
    assert _buckets(24) == [1, 2, 4, 8, 16, 24]
    assert _buckets(1) == [1]


# ---------------------------------------------------------------------------
# Scheduler: parity, ordering, flush timing
# ---------------------------------------------------------------------------
def test_batched_matches_sequential_bitwise(engine, flat, corpus):
    """Coalesced answers == per-query index.search, scores and ids."""
    n_clients = 24  # 3x max_batch: several padded batches
    results = [None] * n_clients
    barrier = threading.Barrier(n_clients)

    def client(i):
        barrier.wait()  # maximal overlap -> real coalescing
        results[i] = engine.search_one(corpus[i], K)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(n_clients):
        ref = flat.search(corpus[i:i + 1], K)
        assert np.array_equal(results[i].indices, ref.indices)
        assert np.array_equal(results[i].scores, ref.scores)
    stats = engine.stats()
    assert stats["requests"] == n_clients
    # coalescing actually happened: fewer searches than requests
    assert stats["batches"] < n_clients
    assert sum(s * c for s, c in
               ((int(k), v) for k, v in stats["batch_size_hist"].items())
               ) == n_clients


def test_interleaved_clients_get_their_own_results(engine, corpus):
    """Each client queries ITS exact corpus row; top-1 must be that row."""
    rows = list(range(0, 64, 2))
    out = {}

    def client(row):
        out[row] = engine.search_one(corpus[row], K)

    threads = [threading.Thread(target=client, args=(r,)) for r in rows]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for row in rows:
        assert out[row].indices[0, 0] == row
        assert out[row].scores[0, 0] == 0.0  # exact row: distance 0


def test_lone_request_flushes_at_max_wait(flat, corpus):
    """A single request must not wait for a full batch: the scheduler
    flushes after max_wait_ms."""
    with SearchEngine(flat, max_batch=64, max_wait_ms=20.0,
                      cache_size=0) as eng:
        eng.warmup(ks=(K,))
        t0 = time.perf_counter()
        res = eng.search_one(corpus[3], K)
        dt = time.perf_counter() - t0
    assert res.indices[0, 0] == 3
    # generous bound: wait (20ms) + a warm small search + scheduling slack
    assert dt < 5.0
    assert eng.stats()["batch_size_hist"] == {"1": 1}


def test_mixed_k_requests_grouped_correctly(engine, corpus):
    out = {}

    def client(i, k):
        out[(i, k)] = engine.search_one(corpus[i], k)

    threads = [threading.Thread(target=client, args=(i, k))
               for i in range(8) for k in (3, 7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (i, k), res in out.items():
        assert res.indices.shape == (1, k)
        assert res.indices[0, 0] == i


def test_search_batch_passthrough_counts_metrics(engine, flat, corpus):
    q = corpus[:16]
    res = engine.search(q, K)
    ref = flat.search(q, K)
    assert np.array_equal(res.indices, ref.indices)
    assert engine.stats()["requests"] == 16


def test_engine_requires_built_index():
    with pytest.raises(RuntimeError, match="before build"):
        SearchEngine(api.FlatIndex(device="cpu"))


def test_engine_rejects_batch_on_single_path(engine, corpus):
    with pytest.raises(ValueError, match="ONE query"):
        engine.search_one(corpus[:4], K)


def test_engine_rejects_wrong_dim_before_batching(engine):
    """A wrong-dim request must fail alone, never poison a shared batch."""
    with pytest.raises(ValueError, match="takes 32-d"):
        engine.search_one(np.zeros(DIM + 1, np.float32), K)


def test_stopped_engine_rejects_instead_of_hanging(flat, corpus):
    eng = SearchEngine(flat, max_batch=4, max_wait_ms=1.0)
    eng.start()
    eng.stop()
    # auto-restart via search_one is allowed; but a direct asearch on a
    # stopping engine errors instead of wedging the caller
    assert not eng._accepting


# ---------------------------------------------------------------------------
# Cache: hits, fingerprint invalidation
# ---------------------------------------------------------------------------
def test_cache_hit_on_repeat_query(engine, corpus):
    q = corpus[9]
    r1 = engine.search_one(q, K)
    h0 = engine.cache.hits
    r2 = engine.search_one(q, K)
    assert engine.cache.hits == h0 + 1
    assert np.array_equal(r1.indices, r2.indices)
    assert engine.stats()["cache"]["hit_rate"] > 0


def test_cached_results_are_frozen(engine, corpus):
    """A caller mutating its result must not poison future cache hits."""
    q = corpus[21]
    r1 = engine.search_one(q, K)
    with pytest.raises(ValueError, match="read-only"):
        r1.indices[0, 0] = -99
    r2 = engine.search_one(q, K)  # hit: still the true answer
    assert r2.indices[0, 0] == 21


def test_cache_distinguishes_k(engine, corpus):
    q = corpus[11]
    engine.search_one(q, 3)
    m0 = engine.cache.misses
    engine.search_one(q, 4)  # same bytes, different k -> miss
    assert engine.cache.misses == m0 + 1


def test_cache_invalidated_by_index_swap(corpus):
    other = _flat(_int_corpus(1))
    with SearchEngine(_flat(corpus), max_batch=4, max_wait_ms=1.0) as eng:
        q = corpus[7]
        before = eng.search_one(q, K)
        eng.search_one(q, K)
        assert eng.cache.hits == 1
        fp0 = eng.stats()["index"]["fingerprint"]
        eng.set_index(other)
        assert eng.stats()["index"]["fingerprint"] != fp0
        after = eng.search_one(q, K)  # must MISS: old entry is stale
        assert eng.cache.hits == 1 and eng.cache.misses == 2
        assert not np.array_equal(before.indices, after.indices)
        ref = other.search(q[None], K)
        assert np.array_equal(after.indices, ref.indices)


def test_fingerprint_stable_across_identical_builds(corpus):
    a = _flat(corpus)
    b = _flat(corpus)
    assert a.fingerprint() == b.fingerprint()
    assert a.fingerprint() != _flat(_int_corpus(2)).fingerprint()


def test_fingerprint_covers_composite_stages(corpus):
    i1 = api.index_factory("PCA8,Flat,Rerank2", device="cpu").build(corpus)
    i2 = api.index_factory("PCA8,Flat,Rerank4", device="cpu").build(corpus)
    assert i1.fingerprint() != i2.fingerprint()


# ---------------------------------------------------------------------------
# Stats / warmup / lifecycle
# ---------------------------------------------------------------------------
def test_stats_surface_shape(engine, corpus):
    engine.search_one(corpus[0], K)
    s = engine.stats()
    for key in ("uptime_s", "requests", "batches", "qps", "batch_size_hist",
                "latency_ms", "cache", "index", "scheduler"):
        assert key in s, key
    assert s["latency_ms"]["p50"] <= s["latency_ms"]["p99"]
    assert s["index"]["ntotal"] == N
    assert s["scheduler"]["max_batch"] == 8
    assert s["distance_evals"] == N  # flat scan touches everything


def test_warmup_does_not_touch_metrics(flat):
    with SearchEngine(flat, max_batch=4) as eng:
        eng.warmup(ks=(K,))
        assert eng.stats()["requests"] == 0


def test_engine_restartable(flat, corpus):
    eng = SearchEngine(flat, max_batch=4, max_wait_ms=1.0)
    assert eng.search_one(corpus[1], K).indices[0, 0] == 1  # auto-start
    eng.stop()
    assert not eng.running
    assert eng.search_one(corpus[2], K).indices[0, 0] == 2  # restart
    eng.stop()


# ---------------------------------------------------------------------------
# HTTP front-end
# ---------------------------------------------------------------------------
@pytest.fixture()
def http_engine(flat):
    # 10ms wait: wide enough that staggered HTTP handler threads still
    # coalesce on a loaded CI box
    eng = SearchEngine(flat, max_batch=8, max_wait_ms=10.0)
    eng.start()
    server, thread = start_http_server(eng, port=0)
    port = server.server_address[1]
    yield eng, port
    server.shutdown()
    eng.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_healthz(http_engine):
    _, port = http_engine
    status, body = _get(port, "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["ntotal"] == N


def test_http_search_single_and_batch(http_engine, flat, corpus):
    _, port = http_engine
    status, body = _post(port, "/search",
                         {"query": corpus[5].tolist(), "k": 3})
    assert status == 200
    assert body["indices"][0] == 5
    assert body["distance_evals"] == N
    ref = flat.search(corpus[:2], 3)
    status, batch = _post(port, "/search",
                          {"queries": corpus[:2].tolist(), "k": 3})
    assert status == 200
    assert batch["indices"] == ref.indices.tolist()


def test_http_stats_reflects_traffic(http_engine, corpus):
    eng, port = http_engine
    _post(port, "/search", {"query": corpus[0].tolist(), "k": K})
    _, stats = _get(port, "/stats")
    assert stats["requests"] >= 1
    assert stats["index"]["fingerprint"] == eng.stats()["index"]["fingerprint"]


def test_http_bad_requests(http_engine):
    _, port = http_engine
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/search", {"k": 3})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404


def _expect_400(port, payload, fragment):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/search", payload)
    assert e.value.code == 400
    body = json.loads(e.value.read())
    assert fragment in body["error"], body["error"]


def test_http_rejects_bad_k(http_engine, corpus):
    """k=0 and negative k must bounce with 400, not slice to an empty or
    reversed result deep inside the index."""
    _, port = http_engine
    q = corpus[3].tolist()
    _expect_400(port, {"query": q, "k": 0}, "k must be >= 1")
    _expect_400(port, {"query": q, "k": -3}, "k must be >= 1")


def test_http_rejects_wrong_dim(http_engine):
    _, port = http_engine
    _expect_400(port, {"query": [1.0] * (DIM + 3), "k": 3},
                f"query dim {DIM + 3} != index dim {DIM}")
    _expect_400(port, {"queries": [[1.0] * (DIM - 1)] * 2, "k": 3},
                f"query dim {DIM - 1} != index dim {DIM}")
    # a batch posted to the single-query field (and vice versa) is a
    # shape error, not a silent reinterpretation
    _expect_400(port, {"query": [[1.0] * DIM] * 2, "k": 3}, "dimension")
    _expect_400(port, {"queries": [1.0] * DIM, "k": 3}, "dimension")


def test_http_rejects_non_finite_query(http_engine, corpus):
    """A NaN query must never reach the engine: the result cache keys on
    query bytes, so a poisoned entry would keep serving garbage."""
    eng, port = http_engine
    q = corpus[3].astype(float).tolist()
    q[0] = float("nan")
    _expect_400(port, {"query": q, "k": 3}, "NaN")
    _expect_400(port, {"queries": [q], "k": 3}, "NaN")
    # the good twin of the poisoned query still answers 200 afterwards
    status, body = _post(port, "/search",
                         {"query": corpus[3].tolist(), "k": 3})
    assert status == 200 and body["indices"][0] == 3


def test_http_concurrent_clients_coalesce(http_engine, flat, corpus):
    eng, port = http_engine
    rows = list(range(16))
    out, errors = {}, {}

    def client(row):
        # a transient connection failure (thundering-herd connect on a
        # loaded box) is retried once; a real error is surfaced below
        for attempt in (0, 1):
            try:
                out[row] = _post(port, "/search",
                                 {"query": corpus[row].tolist(),
                                  "k": K})[1]
                return
            except Exception as e:  # noqa: BLE001 - recorded, re-raised
                errors[row] = e
                time.sleep(0.05)

    threads = [threading.Thread(target=client, args=(r,)) for r in rows]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    missing = [r for r in rows if r not in out]
    assert not missing, f"rows {missing} failed: " \
                        f"{ {r: repr(errors.get(r)) for r in missing} }"
    for row in rows:
        assert out[row]["indices"][0] == row
    assert eng.stats()["batches"] < len(rows)


# ---------------------------------------------------------------------------
# the port beside the reference, on the same inputs
# ---------------------------------------------------------------------------
def test_rejected_http_requests_leave_the_cache_alone(http_engine, corpus):
    """A NaN / Inf or wrong-dim request is refused before the engine: the
    cache neither grows nor counts a lookup for it."""
    eng, port = http_engine
    _post(port, "/search", {"query": corpus[4].tolist(), "k": 3})
    before = eng.cache.stats()
    bad = corpus[4].astype(float).tolist()
    bad[1] = float("inf")
    _expect_400(port, {"query": bad, "k": 3}, "NaN")
    _expect_400(port, {"query": [1.0] * (DIM + 1), "k": 3}, "index dim")
    assert eng.cache.stats() == before


def _reqs(qs, k):
    return [_Request(q=q, k=k, future=None) for q in qs]


@pytest.fixture(scope="module")
def wide_corpus():
    """Integers in [-128, 128): exact float32 distances, and ties between
    a query's nearest rows are rare, so ids can be compared across the
    two packages' tie orders (ROADMAP C8) without a tie-aware oracle."""
    rng = np.random.default_rng(5)
    return rng.integers(-128, 128, (1024, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def saved_ivf(wide_corpus, tmp_path_factory):
    """The reference's IVF16 over ``wide_corpus``, saved, and the port's
    load of it (equal fingerprints)."""
    ref = jax_api.IVFFlatIndex(n_cells=16, seed=0).build(wide_corpus)
    d = str(tmp_path_factory.mktemp("ivf") / "idx")
    ref.save(d)
    port = api.load_index(d, device="cpu")
    assert port.fingerprint() == ref.fingerprint()
    return ref, port


def _assert_no_ties(scores):
    for row in np.asarray(scores):
        fin = row[np.isfinite(row)]
        assert len(np.unique(fin)) == len(fin), row


@pytest.mark.parametrize("tier", ["flat", "ivf"])
@pytest.mark.parametrize("size", [1, 3, 8])
def test_engine_batches_equal_the_reference_engines(tier, size, wide_corpus,
                                                    saved_ivf):
    """The same requests through the reference's engine and the port's
    (a bucket-padded ``_run_batch``): ids and score bits equal."""
    if tier == "flat":
        ref_ix = jax_api.FlatIndex().build(wide_corpus)
        port_ix = api.FlatIndex(device="cpu").build(wide_corpus)
        assert port_ix.fingerprint() == ref_ix.fingerprint()
    else:
        ref_ix, port_ix = saved_ivf
    qs = wide_corpus[np.random.default_rng(size).choice(
        len(wide_corpus), size, replace=False)] + 1.0
    ref_eng = JaxEngine(ref_ix, max_batch=8, cache_size=0)
    port_eng = SearchEngine(port_ix, max_batch=8, cache_size=0)
    want = ref_eng._run_batch(K, _reqs(qs, K))
    got = port_eng._run_batch(K, _reqs(qs, K))
    for w, g in zip(want, got):
        _assert_no_ties(w.scores)
        assert np.array_equal(g.indices, np.asarray(w.indices))
        assert g.scores.tobytes() == np.asarray(w.scores).tobytes()
    assert port_eng.buckets == ref_eng.buckets
    ws, gs = ref_eng.stats(), port_eng.stats()
    assert sorted(gs) == sorted(ws)
    for key in ("requests", "batches", "batch_size_hist", "bucket_hist",
                "distance_evals", "escalation_rate"):
        assert gs[key] == ws[key], key
    assert gs["index"]["fingerprint"] == ws["index"]["fingerprint"]
    assert gs["index"]["kind"] == ws["index"]["kind"]
