"""Self-tuning serving on the port (``repro_torch.tune``, the engine's
operating point and escalation, ``analysis.runtime.no_retrace``), on the
CPU.

The 22 tests of the reference's ``tests/test_autotune.py``, mirrored on
the port with the same corpus (N, DIM, K = 2048, 16, 10; small random
integers cast to float32): the knob ladder and ``SearchParams`` algebra,
per-call knobs, operating-curve monotonicity and persistence, the margin
signal, escalation determinism (a row escalated alone == the same row in
its batch, bit for bit), the cache key carrying the operating point.

Then parity with the reference on the same numpy inputs:
``SearchParams``'s methods on a grid of knobs, ``topk_margin`` and
``unstable_rows`` bit for bit (``-inf`` pads, short rows),
``candidate_params`` for each stack kind, ``sweep`` over an IVF build the
reference saved and the port loaded (every point's recall and
``distance_evals`` equal, the same Pareto params), curves read both ways
(the committed ``results/curve_*.json`` too), the engine's
``target_recall`` selecting the same point, and both engines giving the
same answers and escalation masks, bit for bit, on an integer corpus.
Last, ``no_retrace`` counting a kernel build and a library load.
"""
from __future__ import annotations

import os
import pathlib
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro import tune as jax_tune  # noqa: E402
from repro.serve.engine import SearchEngine as JaxEngine  # noqa: E402
from repro.serve.engine import _Request as JaxRequest  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.analysis.runtime import (RetraceError,  # noqa: E402
                                          compile_count, no_retrace)
from repro_torch.api import (KNOB_LADDER, SearchParams,  # noqa: E402
                             next_rung, snap_knob)
from repro_torch.core.metrics import recall_at_k  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve.engine import SearchEngine, _Request  # noqa: E402
from repro_torch.tune import (EscalationPolicy, OperatingCurve,  # noqa: E402
                              OperatingPoint, load_curve, pareto,
                              save_curve, sweep, topk_margin, unstable_rows)

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, DIM, K = 2048, 16, 10


def _int_corpus(seed: int, n: int = N, dim: int = DIM) -> np.ndarray:
    """Integer-valued f32 vectors: exact arithmetic, so batched and
    per-query scans agree bitwise. Rows are distinct w.p. ~1."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (n, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _int_corpus(0)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(7)
    return corpus[rng.choice(len(corpus), 32, replace=False)].copy()


@pytest.fixture(scope="module")
def ivf(corpus):
    return api.IVFFlatIndex(n_cells=32, seed=0, device="cpu").build(corpus)


@pytest.fixture(scope="module")
def ground_truth(corpus, queries):
    return np.asarray(api.FlatIndex(device="cpu").build(corpus)
                      .search(queries, K).indices)


# ---------------------------------------------------------------------------
# ladder + SearchParams algebra
# ---------------------------------------------------------------------------
def test_ladder_is_strictly_increasing_geometricish():
    steps = np.diff(np.asarray(KNOB_LADDER))
    assert (steps > 0).all()
    ratios = np.asarray(KNOB_LADDER[1:]) / np.asarray(KNOB_LADDER[:-1])
    assert ratios.max() <= 2.0  # no rung more than doubles the work


def test_snap_rounds_up_and_clamps():
    assert snap_knob(1) == KNOB_LADDER[0]
    for r in KNOB_LADDER:
        assert snap_knob(r) == r           # rungs are fixed points
    assert snap_knob(9) == 12
    assert snap_knob(KNOB_LADDER[-1] + 1) == KNOB_LADDER[-1]


def test_next_rung_steps_and_saturates():
    assert next_rung(8) == 12
    assert next_rung(9) == 16              # snap(9)=12, next is 16
    assert next_rung(KNOB_LADDER[-1]) == KNOB_LADDER[-1]


def test_search_params_snap_merge_escalate():
    p = SearchParams(nprobe=9, ef_search=100)
    assert (p.nprobe, p.ef_search, p.rerank_k1) == (12, 128, None)
    assert p == SearchParams(nprobe=12, ef_search=128)  # snapped == equal
    assert p.merged(SearchParams(nprobe=48)).nprobe == 48
    assert p.merged(SearchParams()).ef_search == 128
    e = p.escalated()
    assert (e.nprobe, e.ef_search, e.rerank_k1) == (16, 192, None)
    assert SearchParams.from_dict(p.to_dict()) == p
    with pytest.raises(ValueError, match="must be >= 1"):
        SearchParams(nprobe=0)


# ---------------------------------------------------------------------------
# per-call knobs: behavior + the cold-path budget
# ---------------------------------------------------------------------------
def test_ivf_per_call_nprobe_changes_work(ivf, queries):
    lo = ivf.search(queries, K, params=SearchParams(nprobe=8))
    hi = ivf.search(queries, K, params=SearchParams(nprobe=32))
    assert hi.distance_evals > lo.distance_evals
    # per-call override does NOT move the fingerprint (no state changed)
    fp = ivf.fingerprint()
    ivf.search(queries, K, params=SearchParams(nprobe=16))
    assert ivf.fingerprint() == fp


def test_ivf_laddered_calls_do_not_recompile(ivf, queries):
    """Repeated per-call laddered nprobe overrides pay no cold path once
    each rung has run."""
    rungs = [SearchParams(nprobe=r) for r in (8, 12, 16, 32)]
    for p in rungs:  # warm every rung once at the serving shape
        ivf.search(queries, K, params=p)
    with no_retrace(budget=0, what="laddered nprobe storm"):
        for _ in range(3):
            for p in rungs:
                ivf.search(queries, K, params=p)


def test_two_stage_rerank_k1_override(corpus, queries):
    ts = api.TwoStageIndex(api.make_reducer("pca", 8, device="cpu"),
                           api.IVFFlatIndex(n_cells=32, device="cpu"),
                           rerank_factor=4, device="cpu").build(corpus)
    r = ts.search(queries, K, params=SearchParams(rerank_k1=16))
    assert r.stats["rerank_evals"] == 16.0
    # k1 never drops below k: the rerank can't return unfetched rows
    r2 = ts.search(queries, 24, params=SearchParams(rerank_k1=8))
    assert r2.stats["rerank_evals"] == 24.0


def test_set_params_moves_fingerprint(corpus):
    # local builds: set_params mutates serving state (and the
    # fingerprint with it), so never touch the shared fixtures here
    ix_ivf = api.IVFFlatIndex(n_cells=16, seed=0,
                              device="cpu").build(corpus[:512])
    h = api.HNSWIndex(m=8, ef_search=32, seed=0,
                      device="cpu").build(corpus[:512])
    for ix, p in [(ix_ivf, SearchParams(nprobe=24)),
                  (h, SearchParams(ef_search=96))]:
        fp = ix.fingerprint()
        ix.set_params(p)
        assert ix.fingerprint() != fp, type(ix).__name__


# ---------------------------------------------------------------------------
# operating curve: monotonicity + persistence
# ---------------------------------------------------------------------------
def test_ivf_recall_monotone_along_ladder(ivf, queries, ground_truth):
    """Probed cell sets are nested as nprobe grows, so recall along the
    ladder is non-decreasing."""
    recalls = [recall_at_k(
        ivf.search(queries, K, params=SearchParams(nprobe=r)).indices,
        ground_truth) for r in (8, 12, 16, 24, 32)]
    assert all(b >= a - 1e-12 for a, b in zip(recalls, recalls[1:])), recalls


def test_sweep_returns_pareto_curve(ivf, queries, ground_truth):
    curve = sweep(ivf, queries, ground_truth, K)
    assert curve.fingerprint == ivf.fingerprint() and curve.k == K
    evals = [p.distance_evals for p in curve.points]
    recalls = [p.recall for p in curve.points]
    assert evals == sorted(evals)
    assert all(b > a for a, b in zip(recalls, recalls[1:]))  # strict
    # select: cheapest point covering the target; best-effort at the top
    cheap = curve.select(0.0)
    assert cheap is curve.points[0]
    assert curve.select(2.0) is curve.points[-1]


def test_pareto_drops_dominated_points():
    mk = lambda r, c: OperatingPoint(params=SearchParams(nprobe=8),  # noqa
                                     recall=r, distance_evals=c, qps=1.0)
    front = pareto([mk(0.9, 100), mk(0.8, 200), mk(0.95, 300)])
    assert [(p.recall, p.distance_evals) for p in front] == \
        [(0.9, 100), (0.95, 300)]


def test_curve_roundtrip_and_fingerprint_pinning(tmp_path, ivf, queries,
                                                 ground_truth, corpus):
    curve = sweep(ivf, queries, ground_truth, K,
                  candidates=[SearchParams(nprobe=8),
                              SearchParams(nprobe=16)])
    path = str(tmp_path / "curve.json")
    save_curve(curve, path)
    assert load_curve(path, ivf) == curve
    other = api.IVFFlatIndex(n_cells=16, device="cpu").build(corpus[:512])
    with pytest.raises(ValueError, match="tuned for fingerprint"):
        load_curve(path, other)


# ---------------------------------------------------------------------------
# margin signal
# ---------------------------------------------------------------------------
def test_topk_margin_separates_stable_from_unstable():
    s = np.array([[10.0, 9, 8, 7, 1, 0.9, 0.8],     # insulated top-4
                  [10.0, 9, 8, 7, 6.99, 6.98, 6.97]])  # razor-thin
    m = topk_margin(s, k=4, delta=3)
    assert m[0] > 0.5 and m[1] < 0.05
    u = unstable_rows(s, 4, 3, threshold=0.15, ntotal=10_000)
    assert list(u) == [False, True]


def test_unstable_rows_short_probe_policy():
    short = np.array([[5.0, 4, 3, -np.inf, -np.inf, -np.inf, -np.inf]])
    # a short probe escalates when the corpus holds more...
    assert unstable_rows(short, 4, 3, 0.15, ntotal=10_000)[0]
    # ...but not when the corpus simply has nothing else to offer
    assert not unstable_rows(short, 4, 3, 0.15, ntotal=3)[0]


def test_threshold_extremes_force_none_and_all():
    s = np.array([[10.0, 9, 8, 7, 1, 0.9, 0.8]])
    assert not unstable_rows(s, 4, 3, threshold=0.0, ntotal=100)[0]
    assert unstable_rows(s, 4, 3, threshold=1.5, ntotal=100)[0]


def test_escalation_policy_validation():
    with pytest.raises(ValueError, match="delta"):
        EscalationPolicy(delta=0)
    with pytest.raises(ValueError, match="threshold"):
        EscalationPolicy(threshold=-0.1)
    with pytest.raises(ValueError, match="recall_slack"):
        EscalationPolicy(recall_slack=-0.01)


# ---------------------------------------------------------------------------
# engine: escalation determinism + cold-path budget + the cache key
# ---------------------------------------------------------------------------
def _reqs(qs, k=K, cls=_Request):
    return [cls(q=q, k=k, future=None) for q in qs]


def test_escalated_solo_bitwise_equals_escalated_in_batch(ivf, queries):
    """A query escalated solo returns bitwise the ids/scores of the same
    query escalated inside a coalesced batch (pass 1 and pass 2 ride the
    tiers' row-invariance contract), at a cold-path budget of zero once
    warmup() has run both rungs at every bucket."""
    eng = SearchEngine(ivf, max_batch=4, cache_size=0,
                       params=SearchParams(nprobe=8),
                       escalation=EscalationPolicy(delta=3, threshold=1.5))
    eng.warmup(ks=(K,))
    qs = queries[:4]
    with no_retrace(budget=0, what="escalated solo-vs-batch parity"):
        batch = eng._run_batch(K, _reqs(qs))
        solos = [eng._run_batch(K, _reqs(qs[i:i + 1]))[0]
                 for i in range(len(qs))]
    for i, solo in enumerate(solos):
        assert solo.stats["escalated"] and batch[i].stats["escalated"]
        np.testing.assert_array_equal(solo.indices, batch[i].indices)
        assert solo.scores.tobytes() == batch[i].scores.tobytes()
    assert eng.metrics.snapshot()["escalation_rate"] == 1.0


def test_escalation_off_rows_untouched(ivf, queries):
    """threshold=0 never escalates: answers must equal the plain
    single-pass answers at the base params, bitwise."""
    eng = SearchEngine(ivf, max_batch=4, cache_size=0,
                       params=SearchParams(nprobe=8),
                       escalation=EscalationPolicy(delta=3, threshold=0.0))
    eng.warmup(ks=(K,))
    base = ivf.search(queries[:4], K + 3, params=SearchParams(nprobe=8))
    out = eng._run_batch(K, _reqs(queries[:4]))
    for i, r in enumerate(out):
        assert not r.stats["escalated"]
        np.testing.assert_array_equal(
            r.indices[0], np.asarray(base.indices)[i, :K])
    assert eng.metrics.snapshot()["escalation_rate"] == 0.0


def test_escalated_rows_pay_both_passes_in_stats(ivf, queries):
    eng = SearchEngine(ivf, max_batch=4, cache_size=0,
                       params=SearchParams(nprobe=8),
                       escalation=EscalationPolicy(delta=3, threshold=1.5))
    out = eng._run_batch(K, _reqs(queries[:2]))
    for r in out:
        e1 = r.stats["pass1_distance_evals"]
        e2 = r.stats["pass2_distance_evals"]
        assert e2 > 0 and r.stats["distance_evals"] == pytest.approx(e1 + e2)


def test_cache_key_includes_operating_point(ivf, queries):
    """A knob change on the same fingerprint must not replay cached
    answers computed under the old knobs."""
    with SearchEngine(ivf, max_batch=2, max_wait_ms=0.5,
                      cache_size=64) as eng:
        q = queries[0]
        eng.search_one(q, K)
        eng.search_one(q, K)
        assert eng.cache.hits == 1
        eng.set_operating_point(params=SearchParams(nprobe=32))
        eng.search_one(q, K)          # same query, new knobs: MUST miss
        assert eng.cache.hits == 1
        eng.search_one(q, K)          # same knobs again: hits again
        assert eng.cache.hits == 2


def test_engine_target_recall_selects_cheapest_point(ivf):
    mk = lambda r, c, np_: OperatingPoint(  # noqa: E731
        params=SearchParams(nprobe=np_), recall=r, distance_evals=c,
        qps=1.0)
    curve = OperatingCurve(points=(mk(0.9, 100, 8), mk(0.97, 200, 12),
                                   mk(0.999, 400, 24)),
                           fingerprint=ivf.fingerprint(), k=K)
    eng = SearchEngine(ivf, target_recall=0.95, curve=curve)
    assert eng._params.nprobe == 12
    # recall_slack discounts the selection: escalation is trusted to
    # close the gap, so the engine starts a rung cheaper and derives
    # pass 2 one ladder rung up from there
    eng2 = SearchEngine(ivf, target_recall=0.95, curve=curve,
                        escalation=EscalationPolicy(recall_slack=0.08))
    assert eng2._params.nprobe == 8        # 0.90 >= 0.95 - 0.08
    assert eng2._esc_params.nprobe == 12
    with pytest.raises(ValueError, match="needs an OperatingCurve"):
        SearchEngine(ivf, target_recall=0.9)
    with pytest.raises(ValueError, match="pass-2 operating point"):
        SearchEngine(ivf, escalation=EscalationPolicy())


def test_engine_rejects_foreign_curve(corpus, ivf):
    other = api.IVFFlatIndex(n_cells=16, device="cpu").build(corpus[:512])
    curve = OperatingCurve(
        points=(OperatingPoint(params=SearchParams(nprobe=8), recall=0.99,
                               distance_evals=1.0, qps=1.0),),
        fingerprint=other.fingerprint(), k=K)
    with pytest.raises(ValueError, match="tuned for fingerprint"):
        SearchEngine(ivf, target_recall=0.9, curve=curve)


# ---------------------------------------------------------------------------
# the port beside the reference, on the same inputs
# ---------------------------------------------------------------------------
GRID = [None, 1, 8, 9, 100, 512, 2048, 5000]


@pytest.mark.parametrize("nprobe", GRID)
def test_search_params_methods_match_reference(nprobe):
    for ef in GRID:
        for k1 in GRID[:4]:
            p = SearchParams(ef_search=ef, nprobe=nprobe, rerank_k1=k1)
            r = jax_api.SearchParams(ef_search=ef, nprobe=nprobe,
                                     rerank_k1=k1)
            assert p.key() == r.key()
            assert p.escalated().key() == r.escalated().key()
            assert p.to_dict() == r.to_dict()
            assert SearchParams.from_dict(r.to_dict()) == p
            o = SearchParams(nprobe=ef, rerank_k1=nprobe)
            ro = jax_api.SearchParams(nprobe=ef, rerank_k1=nprobe)
            assert p.merged(o).key() == r.merged(ro).key()


def _score_matrix(seed, rows=64, cols=16):
    """Descending score rows: negative distances, some ties, some rows
    short (``-inf`` pads from a given column), one row all ``-inf``."""
    rng = np.random.default_rng(seed)
    s = -np.sort(rng.integers(0, 40, (rows, cols)).astype(np.float32), 1)
    s[:, : cols // 2] += rng.standard_normal((rows, cols // 2)) * 1e-3
    s = -np.sort(-s, 1)
    for r in range(0, rows, 5):
        s[r, rng.integers(1, cols):] = -np.inf
    s[3] = -np.inf
    s[7] = s[7, 0]                     # a full tie
    return s


@pytest.mark.parametrize("seed", range(4))
def test_margin_and_unstable_rows_match_reference_bitwise(seed):
    s = _score_matrix(seed)
    for k, delta in ((4, 3), (10, 3), (1, 1), (8, 8)):
        a = topk_margin(s, k, delta)
        b = jax_tune.topk_margin(s, k, delta)
        assert a.tobytes() == b.tobytes()
        for thr in (0.0, 0.02, 0.15, 0.5, 1.5):
            for ntotal in (None, 3, 10_000):
                np.testing.assert_array_equal(
                    unstable_rows(s, k, delta, thr, ntotal=ntotal),
                    jax_tune.unstable_rows(s, k, delta, thr, ntotal=ntotal))


CANDIDATE_SPECS = ["Flat", "IVF16", "HNSW8", "SQ8", "PQ4x4", "IVF16,SQ8",
                   "IVF16,PQ4x4", "HNSW8,SQ8", "PCA8,HNSW8,Rerank4",
                   "PCA8,IVF16,Rerank4", "Mut,PCA8,HNSW8,Rerank4",
                   "Mut,IVF16", "Shard2,IVF16", "PCA8,Shard2,IVF16,Rerank2"]


@pytest.mark.parametrize("spec", CANDIDATE_SPECS)
def test_candidate_params_match_reference(spec, corpus):
    kw = {"ef_construction": 40} if "HNSW" in spec else None
    x = corpus[:400]
    port = api.index_factory(spec, index_kw=kw, device="cpu").build(x)
    ref = jax_api.index_factory(spec, index_kw=kw).build(x)
    for k in (1, 10, 40):
        for max_rung in (64, 512):
            got = [p.key() for p in tune.candidate_params(port, k, max_rung)]
            want = [p.key() for p in jax_tune.candidate_params(ref, k,
                                                               max_rung)]
            assert got == want, (spec, k, max_rung)


@pytest.fixture(scope="module")
def wide_corpus():
    """Integers in [-128, 128): exact float32 distances, and ties between
    a query's nearest rows are rare, so ids and recall compare across the
    two packages' tie orders (ROADMAP C8)."""
    rng = np.random.default_rng(5)
    return rng.integers(-128, 128, (N, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def shared_ivf(wide_corpus, tmp_path_factory):
    """The reference's IVF32 over ``wide_corpus``, saved, and the port's
    load of it (equal fingerprints); held-out queries and the exact
    ground truth."""
    ref = jax_api.IVFFlatIndex(n_cells=32, seed=0).build(wide_corpus)
    d = str(tmp_path_factory.mktemp("ivf") / "idx")
    ref.save(d)
    port = api.load_index(d, device="cpu")
    assert port.fingerprint() == ref.fingerprint()
    rng = np.random.default_rng(11)
    qs = (wide_corpus[rng.choice(N, 48, replace=False)]
          + rng.integers(-6, 7, (48, DIM))).astype(np.float32)
    gt = np.asarray(jax_api.FlatIndex().build(wide_corpus)
                    .search(qs, K).indices)
    return ref, port, qs, gt


def test_sweep_matches_reference_on_a_reference_built_stack(shared_ivf,
                                                            tmp_path):
    """Every candidate's recall and distance_evals equal, the same Pareto
    params; each package reads the other's saved curve."""
    ref, port, qs, gt = shared_ivf
    cands = tune.candidate_params(port, K)
    assert len(cands) > 3
    for p in cands:
        rp = jax_api.SearchParams(**p.to_dict())
        a = port.search(qs, K, params=p)
        b = ref.search(qs, K, params=rp)
        np.testing.assert_array_equal(a.indices, np.asarray(b.indices))
        assert a.scores.tobytes() == np.asarray(b.scores).tobytes()
        assert a.distance_evals == b.distance_evals
        hits = sum(len(np.intersect1d(r, g)) for r, g in zip(a.indices, gt))
        assert recall_at_k(a.indices, gt) == np.float32(hits / gt.size)
    got = sweep(port, qs, gt, K)
    want = jax_tune.sweep(ref, qs, gt, K)
    assert got.fingerprint == want.fingerprint and got.k == want.k
    assert [(p.params.key(), p.distance_evals) for p in got.points] == \
        [(p.params.key(), p.distance_evals) for p in want.points]
    # the same answers; the reference's float32 mean (an XLA reduction)
    # may round the hit ratio one ulp off the exact quotient the port's
    # gives (405 / 480: 0.84375006 against 0.84375)
    for g, w in zip(got.points, want.points):
        assert abs(g.recall - w.recall) <= np.spacing(np.float32(w.recall))
    # curves read both ways, pinned to the shared fingerprint
    save_curve(got, str(tmp_path / "port.json"))
    jax_tune.save_curve(want, str(tmp_path / "ref.json"))
    back = jax_tune.load_curve(str(tmp_path / "port.json"), ref)
    assert [(p.params.key(), p.recall, p.distance_evals, p.qps)
            for p in back.points] == \
        [(p.params.key(), p.recall, p.distance_evals, p.qps)
         for p in got.points]
    here = load_curve(str(tmp_path / "ref.json"), port)
    assert [(p.params.key(), p.recall, p.distance_evals, p.qps)
            for p in here.points] == \
        [(p.params.key(), p.recall, p.distance_evals, p.qps)
         for p in want.points]
    # the engine's target_recall selects the same point in both packages
    for target in (0.5, 0.9, 0.99, 1.0):
        for slack in (0.0, 0.05):
            esc = EscalationPolicy(recall_slack=slack)
            resc = jax_tune.EscalationPolicy(recall_slack=slack)
            pe = SearchEngine(port, target_recall=target, curve=here,
                              escalation=esc)
            re_ = JaxEngine(ref, target_recall=target, curve=want,
                            escalation=resc)
            assert pe._params.key() == re_._params.key()
            assert pe._esc_params.key() == re_._esc_params.key()


@pytest.mark.parametrize("threshold", [0.02, 0.05, 1.5])
def test_escalating_engine_matches_reference_bitwise(shared_ivf, threshold):
    """The same batch through both packages' escalating engines (integer
    corpus, the reference's IVF build): answers, score bits and the
    escalation mask equal."""
    ref, port, qs, _ = shared_ivf
    pe = SearchEngine(port, max_batch=16, cache_size=0,
                      params=SearchParams(nprobe=8),
                      escalation=EscalationPolicy(delta=3,
                                                  threshold=threshold))
    re_ = JaxEngine(ref, max_batch=16, cache_size=0,
                    params=jax_api.SearchParams(nprobe=8),
                    escalation=jax_tune.EscalationPolicy(
                        delta=3, threshold=threshold))
    masks = []
    for s in range(0, len(qs), 12):   # 12 rows pad to the 16 bucket
        got = pe._run_batch(K, _reqs(qs[s:s + 12]))
        want = re_._run_batch(K, _reqs(qs[s:s + 12], cls=JaxRequest))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
            assert g.scores.tobytes() == np.asarray(w.scores).tobytes()
            assert g.stats["escalated"] == w.stats["escalated"]
            assert g.stats["distance_evals"] == w.stats["distance_evals"]
            masks.append(g.stats["escalated"])
    if threshold == 0.05:
        assert 0 < sum(masks) < len(masks)      # the mask splits batches
    assert pe.metrics.snapshot()["escalation_rate"] == \
        re_.metrics.snapshot()["escalation_rate"]


COMMITTED_CURVES = sorted((ROOT / "results").glob("curve_*_k10.json"))


@pytest.mark.parametrize("path", COMMITTED_CURVES,
                         ids=[p.name for p in COMMITTED_CURVES])
def test_committed_curves_load_as_the_reference_reads_them(path, corpus):
    """The reference's committed curves: the port reads points, params and
    fingerprint as the reference does, and refuses them against an index
    of another fingerprint with the reference's message."""
    got = load_curve(str(path))
    want = jax_tune.load_curve(str(path))
    assert got.fingerprint == want.fingerprint == path.name.split("_")[1]
    assert got.k == want.k == K
    assert [(p.params.key(), p.recall, p.distance_evals, p.qps)
            for p in got.points] == \
        [(p.params.key(), p.recall, p.distance_evals, p.qps)
         for p in want.points]
    port = api.FlatIndex(device="cpu").build(corpus[:64])
    ref = jax_api.FlatIndex().build(corpus[:64])
    with pytest.raises(ValueError) as e_port:
        load_curve(str(path), port)
    with pytest.raises(ValueError) as e_ref:
        jax_tune.load_curve(str(path), ref)
    assert str(e_port.value).replace("repro_torch.tune", "repro.tune") == \
        str(e_ref.value)


def test_committed_curve_count():
    # the IVF256 and HNSW32 curves of table8_autotune --quick
    assert [p.name for p in COMMITTED_CURVES] == [
        "curve_0b7f86c76c2cfdd7_k10.json", "curve_66cd981af24cffcc_k10.json"]


# ---------------------------------------------------------------------------
# no_retrace: what it counts on the card, counted here with a stand-in
# ---------------------------------------------------------------------------
@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    """A build directory of its own and an ``nvcc`` that writes an empty
    library; ``ctypes.CDLL`` stands in for the loader. The load cache is
    cleared before and after, so nothing fake outlives the test."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    _build.load.cache_clear()
    yield tmp_path / "build"
    _build.load.cache_clear()


def test_no_retrace_counts_kernel_builds_and_loads(fake_toolchain):
    start = compile_count()
    with no_retrace(budget=2, what="cold kernel") as used:
        lib = _build.load("rae_encode")        # one nvcc build, one load
        assert used() == 2
        assert _build.load("rae_encode") is lib    # loaded: costs nothing
        assert used() == 2
    assert compile_count() == start + 2
    assert os.path.exists(_build.library_path("rae_encode"))
    _build.load.cache_clear()
    with no_retrace(budget=1, what="library already built") as used:
        _build.load("rae_encode")              # the library exists: a load
        assert used() == 1


def test_no_retrace_raises_over_budget(fake_toolchain):
    with pytest.raises(RetraceError, match="budget 0"):
        with no_retrace(budget=0, what="warm storm"):
            _build.build(("l2_topk",))
    with no_retrace(budget=0, what="warm storm"):
        _build.build(("l2_topk",))             # built: nothing to pay
