"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernels are built at
first use) and skips without one. The file imports only torch, numpy and
``repro_torch``, so it runs on a machine without JAX:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: on integer-valued inputs every product and sum is exact in
float32, so kernel and plain version must agree bit for bit, ids and
scores; on float inputs ids must be equal and values within 1e-4 of the
largest magnitude (float32 sums in another order; the encoder's 3xTF32
products on the tensor cores, about 6e-6 off), except for the
``graph_beam`` hop, whose kernel sums in its plain version's order and
must agree bit for bit on every input, and the one-launch traversal built
on it, which must equal the loop of plain hops bit for bit (ids, scores,
evals, hops). The ``l2_topk`` scan sums in the plain version's matmul
order, so its scores are bit-equal too where cuBLAS sums a batch (one
query is held against the plain version inside a batch of 64: cuBLAS sums
a one-row product in another order). The ``topk_merge`` kernel orders
by the plain version's keys and must agree with it bit for bit too, and
the ``pq_adc`` and ``graph_beam_q`` kernels sum in their plain versions'
trees (the LUT, the m looked-up entries, the SQ8 dot) and must agree bit
for bit on every input. The ``embedding_bag`` kernel adds a bag's rows in
its plain version's slot order and must agree with it bit for bit, and so
must its backward, which sums each table row's slots in ascending (b, l)
(the train steps built on it equal their plain path's and repeat
themselves bit for bit); the
``flash_decode`` kernel splits the KV axis and merges the partial
softmaxes, so it is held within 1e-5 of the largest magnitude, with no
floor: its outputs average V over up to 70,001 positions and are small,
and one position dropped or added moves them by far more than that.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from repro_torch import api  # noqa: E402
from repro_torch.kernels import (embedding_bag, embedding_bag_bwd,  # noqa: E402
                                 flash_decode, graph_beam, graph_beam_q,
                                 pq_adc)
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.kernel import (  # noqa: E402
    embedding_bag_bwd_cuda, embedding_bag_cuda)
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_bwd_ref, embedding_bag_ref)
from repro_torch.kernels.flash_decode.kernel import flash_decode_cuda  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.common import NEG_INF  # noqa: E402
from repro_torch.kernels.graph_beam import kernel as graph_beam_kernel  # noqa: E402
from repro_torch.kernels.graph_beam.kernel import (  # noqa: E402
    graph_beam_cuda, graph_traverse_cuda)
from repro_torch.kernels.graph_beam.ref import (  # noqa: E402
    graph_beam_ref, graph_traverse_ref, pairwise_sum)
from repro_torch.kernels.graph_beam_q.kernel import (  # noqa: E402
    graph_beam_q_cuda, graph_traverse_q_cuda)
from repro_torch.kernels.graph_beam_q.ref import (  # noqa: E402
    graph_beam_q_ref, graph_traverse_q_ref)
from repro_torch.kernels import l2_topk  # noqa: E402
from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda  # noqa: E402
from repro_torch.kernels.l2_topk.ref import (l2_topk_ref,  # noqa: E402
                                             l2_topk_scan_ref, prepare)
from repro_torch.kernels.pq_adc.kernel import pq_adc_cuda  # noqa: E402
from repro_torch.kernels.pq_adc.ref import pq_adc_ref  # noqa: E402
from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda  # noqa: E402
from repro_torch.kernels.rae_encode.ref import rae_encode_ref  # noqa: E402
from repro_torch.kernels import topk_merge  # noqa: E402
from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda  # noqa: E402
from repro_torch.kernels.topk_merge.ref import topk_merge_ref  # noqa: E402
from repro_torch.search import hnsw  # noqa: E402
from repro_torch.analysis.runtime import no_retrace  # noqa: E402
from repro_torch.serve import SearchEngine  # noqa: E402
from repro_torch.serve.engine import _Request  # noqa: E402
from repro_torch.tune import EscalationPolicy  # noqa: E402

# a string condition is evaluated when the test runs, not at import
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card and nvcc")
TOL = 1e-4
DECODE_REL = 1e-5


def _ints(seed, shape, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape)
                             * scale).astype(np.float32))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


def _close_decode(got, want):
    err, top = float((got - want).abs().max()), float(want.abs().max())
    assert err <= DECODE_REL * top if top > 0 else err == 0, (err, top)


@needs_card
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape", [(77, 129, 16), (4096, 768, 64),
                                   (300, 64, 512), (5, 1, 1)])
def test_rae_encode_kernel_matches_plain(shape, normalize):
    rows, n, m = shape
    x = _normal(1, (rows, n)).cuda()
    w = _normal(2, (n, m), n ** -0.5).cuda()
    z = rae_encode_cuda(x, w, normalize)
    torch.cuda.synchronize()
    _close(z, rae_encode_ref(x, w, normalize))


@needs_card
def test_rae_encode_kernel_integer_inputs_bit_equal():
    x, w = _ints(1, (333, 200)).cuda(), _ints(2, (200, 64), -2, 3).cuda()
    z = rae_encode_cuda(x, w, False)
    assert torch.equal(z, rae_encode_ref(x, w, False))


def _offset_view(t):
    """The same values, contiguous, one element past a 16-byte boundary: the
    kernels' scalar-load variants."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# rae_encode's in-kernel variants: each block-tile tier (m <= 64, 128, 256,
# 512), the 16-byte ring (n, m multiples of 4) and the scalar loads (n = 1,
# 129; m = 1), a contraction that ends mid-slice (770), 333 rows (no
# multiple of any row tile)
@needs_card
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("m", [1, 8, 100, 512])
@pytest.mark.parametrize("n", [1, 129, 770])
def test_rae_encode_kernel_every_tier_and_ragged_contraction(n, m, normalize):
    x = _normal(n, (333, n)).cuda()
    w = _normal(m, (n, m), n ** -0.5).cuda()
    z = rae_encode_cuda(x, w, normalize)
    torch.cuda.synchronize()
    _close(z, rae_encode_ref(x, w, normalize))


# the tensor-memory-accelerator / wgmma path (m <= 64, n and m multiples of
# 4, aligned rows): a contraction that ends mid-slice (4, 132), outputs
# narrower than its 64 columns, 333 rows (no multiple of its 128)
@needs_card
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("m", [4, 8, 60, 64])
@pytest.mark.parametrize("n", [4, 132, 768])
def test_rae_encode_kernel_tensor_map_path(n, m, normalize):
    x = _normal(n + 1, (333, n)).cuda()
    w = _normal(m + 1, (n, m), n ** -0.5).cuda()
    z = rae_encode_cuda(x, w, normalize)
    torch.cuda.synchronize()
    _close(z, rae_encode_ref(x, w, normalize))


@needs_card
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape", [(4096, 768, 64), (333, 128, 100),
                                   (45, 64, 512)])
def test_rae_encode_kernel_unaligned_rows(shape, normalize):
    rows, n, m = shape
    x = _offset_view(_normal(4, (rows, n)).cuda())
    w = _normal(5, (n, m), n ** -0.5).cuda()
    z = rae_encode_cuda(x, w, normalize)
    torch.cuda.synchronize()
    _close(z, rae_encode_ref(x, w, normalize))
    _close(rae_encode_cuda(x, _offset_view(w), normalize),
           rae_encode_ref(x, w, normalize))


@needs_card
@pytest.mark.parametrize("shape", [(333, 129, 64), (130, 770, 100),
                                   (77, 64, 512), (5, 1, 1), (333, 132, 60)])
def test_rae_encode_kernel_integer_inputs_bit_equal_every_variant(shape):
    rows, n, m = shape
    x, w = _ints(6, (rows, n)).cuda(), _ints(7, (n, m), -2, 3).cuda()
    assert torch.equal(rae_encode_cuda(x, w, False),
                       rae_encode_ref(x, w, False))
    assert torch.equal(rae_encode_cuda(_offset_view(x), w, False),
                       rae_encode_ref(x, w, False))


@needs_card
@pytest.mark.parametrize("k", [1, 10, 40, 193, 2048, 4032])
@pytest.mark.parametrize("shape", [(19, 333, 16), (257, 20011, 64)])
def test_l2_topk_kernel_integer_corpus_bit_equal(shape, k):
    nq, n, d = shape
    q, db, d_sq = prepare(_ints(k, (nq, d)).cuda(),
                          _ints(k + 1, (n, d)).cuda(), "euclidean", None)
    v, i = l2_topk_scan_cuda(q, db, d_sq, k)
    torch.cuda.synchronize()
    vr, ir = l2_topk_scan_ref(q, db, d_sq, k)
    assert torch.equal(i, ir)
    assert torch.equal(v, vr)


@needs_card
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("nq,n,k", [(33, 5000, 40), (4, 6, 10), (1, 70, 64)])
def test_l2_topk_op_matches_plain(nq, n, k, metric, masked):
    q, db = _normal(nq, (nq, 24)).cuda(), _normal(n, (n, 24)).cuda()
    mask = (torch.rand(n, generator=torch.Generator().manual_seed(0))
            > 0.3).cuda() if masked else None
    v, i = l2_topk(q, db, k, metric=metric, db_mask=mask)
    vr, ir = l2_topk_ref(q, db, k, metric=metric, db_mask=mask)
    assert torch.equal(i, ir)
    _close(v, vr)


def _scan_plain(q, db, d_sq, k):
    """The plain scan; one query is scored inside a batch of 64 (zero
    rows), since cuBLAS sums a one-row product in another order than a
    batch's (about a third of the scores differ in their last bit) and
    near-tied ids would swap."""
    if q.shape[0] > 1:
        return l2_topk_scan_ref(q, db, d_sq, k)
    pad = torch.cat([q, torch.zeros(63, q.shape[1], device=q.device)])
    v, i = l2_topk_scan_ref(pad, db, d_sq, k)
    return v[:1], i[:1]


# the kernel's selection at every k: one query (all blocks on one query
# tile), 65 queries (a ragged second tile), 130 and d = 24 / d = 7 (slices
# that end mid-way, 7: the 4-byte copies), N ragged against every tile
@needs_card
@pytest.mark.parametrize("k", [1, 10, 40, 64, 2048, 4032])
@pytest.mark.parametrize("nq,n,d", [(1, 4999, 64), (65, 70001, 64),
                                    (130, 3001, 24), (64, 100, 7)])
def test_l2_topk_kernel_matches_plain_every_k(nq, n, d, k):
    q, db, d_sq = prepare(_normal(nq + k, (nq, d)).cuda(),
                          _normal(n + k, (n, d)).cuda(), "euclidean", None)
    v, i = l2_topk_scan_cuda(q, db, d_sq, k)
    torch.cuda.synchronize()
    vr, ir = _scan_plain(q, db, d_sq, k)
    assert torch.equal(i, ir)
    _close(v, vr)
    # rows off a 16-byte boundary take the 4-byte copies: the same bits
    v2, i2 = l2_topk_scan_cuda(_offset_view(q), _offset_view(db), d_sq, k)
    assert torch.equal(i2, i) and torch.equal(v2, v)


# every score equal (zero vectors; one row repeated), and a {-1, 0, 1}
# corpus with dense ties: bit-equal, ties to the lower id
@needs_card
@pytest.mark.parametrize("k", [1, 40, 2048, 4032])
@pytest.mark.parametrize("kind", ["zeros", "one_row", "ints"])
def test_l2_topk_kernel_ties_bit_equal(kind, k):
    nq, n, d = 70, 9001, 16
    if kind == "zeros":
        q, db = torch.zeros(nq, d), torch.zeros(n, d)
    elif kind == "one_row":
        q, db = _normal(1, (nq, d)), _normal(2, (1, d)).repeat(n, 1)
    else:
        q, db = _ints(k, (nq, d), -1, 2), _ints(k + 1, (n, d), -1, 2)
    q, db, d_sq = prepare(q.cuda(), db.cuda(), "euclidean", None)
    v, i = l2_topk_scan_cuda(q, db, d_sq, k)
    torch.cuda.synchronize()
    vr, ir = l2_topk_scan_ref(q, db, d_sq, k)
    assert torch.equal(i, ir)
    assert torch.equal(v, vr)


@needs_card
@pytest.mark.parametrize("k", [10, 64, 2048])
def test_l2_topk_masked_rows_never_surface(k):
    """About 2,000 of 5,003 rows live: at k = 2048 the tail is pads."""
    nq, n = 33, 5003
    q, db = _normal(3, (nq, 32)).cuda(), _normal(4, (n, 32)).cuda()
    mask = (torch.rand(n, generator=torch.Generator().manual_seed(1))
            > 0.6).cuda()
    v, i = l2_topk(q, db, k, db_mask=mask)
    vr, ir = l2_topk_ref(q, db, k, db_mask=mask)
    assert torch.equal(i, ir)
    _close(v, vr)
    dead = torch.nonzero(~mask).flatten().to(torch.int32)
    assert not torch.isin(i, dead).any()


@needs_card
def test_kernel_wrappers_reject_what_they_do_not_take():
    q, db = torch.zeros((2, 8), device="cuda"), torch.zeros((9, 8),
                                                            device="cuda")
    d_sq = torch.zeros(9, device="cuda")
    with pytest.raises(ValueError, match="k <= 4032"):
        l2_topk_scan_cuda(q, db, d_sq, 4033)
    with pytest.raises(ValueError, match="CUDA device"):
        l2_topk_scan_cuda(q.cpu(), db, d_sq, 1)
    with pytest.raises(ValueError, match="m <= 512"):
        rae_encode_cuda(q, torch.zeros((8, 513), device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        rae_encode_cuda(q.double(), torch.zeros((8, 4), device="cuda"))


@needs_card
def test_flat_and_twostage_on_card_answer_like_the_plain_path(tmp_path):
    """Integer-valued corpus: the card's answers equal the CPU path's
    bit for bit, and each search launches each kernel once."""
    corpus = _ints(3, (3000, 32)).numpy()
    queries = _ints(4, (40, 32)).numpy()
    cpu = api.FlatIndex(device="cpu").build(corpus).search(queries, 25)
    gpu = api.FlatIndex(device="cuda").build(corpus).search(queries, 25)
    np.testing.assert_array_equal(gpu.indices, cpu.indices)
    np.testing.assert_array_equal(gpu.scores, cpu.scores)

    idx = api.index_factory("RAE8,Flat,Rerank4", reducer_kw={"steps": 50})
    idx.build(corpus)
    rae_encode_cuda.launches = l2_topk_scan_cuda.launches = 0
    res = idx.search(queries, 10)
    assert (rae_encode_cuda.launches, l2_topk_scan_cuda.launches) == (1, 1)
    # with a bias the kernel still runs; the bias is added after it
    b_e = torch.linspace(-1.0, 1.0, 8, device="cuda")
    idx.reducer.params_["b_e"] = b_e
    z = idx.reducer.transform(queries)
    assert rae_encode_cuda.launches == 2
    _close(z, torch.as_tensor(queries, device="cuda")
           @ idx.reducer.params_["w_e"] + b_e)
    del idx.reducer.params_["b_e"]
    idx.save(str(tmp_path / "i"))
    # the plain path encodes in another summation order, which may break
    # ties between equal integer distances differently: compare distances
    back = api.load_index(str(tmp_path / "i"), device="cpu")
    np.testing.assert_array_equal(back.search(queries, 10).scores,
                                  res.scores)


def _beam(q_n, ef, live, empty=NEG_INF):
    bv = torch.full((q_n, ef), empty)
    bi = torch.full((q_n, ef), -1, dtype=torch.int32)
    for s in range(min(live, ef)):
        bv[:, s] = -1000.25 - s      # below every integer score: no ties
        bi[:, s] = s
    return bv, bi


@needs_card
@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("q_n,n,d,w,ef,live", [
    (7, 60, 16, 9, 8, 2), (5, 30, 8, 1, 6, 0), (3, 20, 4, 3, 15, 3),
    (4, 25, 1, 5, 4, 1), (33, 5000, 64, 64, 80, 40), (2, 900, 64, 1024, 1, 1),
    (3, 3000, 24, 300, 4096, 100)])
def test_graph_beam_kernel_matches_plain(q_n, n, d, w, ef, live, integer):
    rng = np.random.default_rng(q_n + w)
    if integer:
        q, db = _ints(1, (q_n, d)), _ints(2, (n, d))
    else:
        q, db = _normal(1, (q_n, d)), _normal(2, (n, d))
    ids = torch.from_numpy(rng.integers(-1, n, (q_n, w)).astype(np.int32))
    bv, bi = _beam(q_n, ef, live, empty=-np.inf if live % 2 else NEG_INF)
    mask = torch.from_numpy(rng.random(n) > 0.25)
    mask[:live] = True
    args = [t.cuda() for t in (q, db, ids, bv, bi)]
    for db_mask in (None, mask.cuda()):
        v, i = graph_beam(*args, db_mask=db_mask)
        torch.cuda.synchronize()
        vr, ir = graph_beam_ref(*args, db_mask=db_mask)
        # the kernel sums in the plain version's pairwise tree: bit-equal
        assert torch.equal(i, ir)
        assert torch.equal(v, vr)


@needs_card
def test_graph_beam_kernel_limits_and_launch_counter():
    q, db = torch.zeros((2, 8), device="cuda"), torch.zeros((9, 8),
                                                            device="cuda")
    sq = torch.zeros(9, device="cuda")
    qsq = torch.zeros(2, device="cuda")

    def call(w, ef):
        ids = torch.zeros((2, w), dtype=torch.int32, device="cuda")
        bv = torch.full((2, ef), NEG_INF, device="cuda")
        bi = torch.full((2, ef), -1, dtype=torch.int32, device="cuda")
        return graph_beam_cuda(q, db, sq, qsq, ids, bv, bi)

    with pytest.raises(ValueError, match="W <= 1024"):
        call(1025, 8)
    with pytest.raises(ValueError, match="ef <= 4096"):
        call(8, 4097)
    graph_beam_cuda.launches = 0
    call(1024, 4096)
    call(1, 1)
    assert graph_beam_cuda.launches == 2


@needs_card
def test_hnsw_index_on_card_answers_like_the_cpu_index(tmp_path):
    """The device traversal (kernel hop) against the same index on the
    CPU (plain hop): equal ids for >= 99% of queries, each search through
    the kernel; a lone query on the card takes the device traversal."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 32)) * 4
    corpus = (centers[rng.integers(0, 8, 3000)]
              + rng.normal(size=(3000, 32))).astype(np.float32)
    queries = corpus[rng.integers(0, 3000, 200)] + 0.01
    gpu = api.HNSWIndex(m=8, ef_construction=40).build(corpus)
    gpu.save(str(tmp_path / "g"))
    cpu = api.load_index(str(tmp_path / "g"), device="cpu")
    graph_traverse_cuda.launches = graph_beam_cuda.launches = 0
    got = gpu.search(queries, 10)
    assert (graph_traverse_cuda.launches, graph_beam_cuda.launches) == (1, 0)
    want = cpu.search(queries, 10)
    same = np.mean([set(a) == set(b)
                    for a, b in zip(got.indices.tolist(),
                                    want.indices.tolist())])
    assert same >= 0.99, same
    rows = (got.indices == want.indices).all(axis=1)
    _close(torch.from_numpy(got.scores[rows]),
           torch.from_numpy(want.scores[rows]))
    assert "beam_hops" in gpu.search(queries[:1], 10).stats
    # a query answers the same alone and in the batch
    solo = gpu.search(queries[3:4], 10)
    np.testing.assert_array_equal(solo.indices[0], got.indices[3])
    np.testing.assert_array_equal(solo.scores[0], got.scores[3])


@pytest.fixture(scope="module")
def card_graph():
    """A 1,500-node graph (d = 64, M = 8, built on the host) and 64 noisy
    queries."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 64)) * 3
    x = (centers[rng.integers(0, 8, 1500)]
         + rng.normal(size=(1500, 64))).astype(np.float32)
    g = hnsw.build(x, M=8, ef_construction=40, seed=0)
    q = (x[rng.integers(0, 1500, 64)]
         + 0.05 * rng.normal(size=(64, 64))).astype(np.float32)
    return g, q


def _alive(g, tomb):
    if not tomb:
        return None
    alive = np.random.default_rng(2).random(g.ntotal) > 0.3
    alive[g.entry] = True
    return alive


@needs_card
@pytest.mark.parametrize("tomb", [False, True], ids=["all", "tombstones"])
@pytest.mark.parametrize("ef", [1, 10, 80, 4096])
def test_graph_traversal_kernel_equals_plain_hop_loop(card_graph, ef, tomb):
    """One launch a search; ids, scores (bit-equal), evals and hops equal
    to the batched loop of plain hops, and to the per-query plain model
    (each row's hops included)."""
    g, q = card_graph
    alive, k = _alive(g, tomb), min(10, ef)
    graph_traverse_cuda.launches = graph_beam_cuda.launches = 0
    got = hnsw.search_batched(g, q, k, ef_search=ef, device="cuda",
                              alive=alive)
    assert (graph_traverse_cuda.launches, graph_beam_cuda.launches) == (1, 0)
    want = hnsw.search_batched(g, q, k, ef_search=ef, device="cuda",
                               alive=alive, hop=graph_beam_ref)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]
    vecs, vsq, nbrs0, upper = g.pack().device_arrays(g.vecs,
                                                     torch.device("cuda"))
    qt = torch.as_tensor(q, device="cuda")
    mask = None if alive is None else torch.as_tensor(alive, device="cuda")
    kern = graph_traverse_cuda(qt, vecs, vsq, pairwise_sum(qt * qt), nbrs0,
                               upper, g.entry, max(ef, k), alive=mask)
    cpu = [t.cpu() for t in (qt, vecs, vsq, pairwise_sum(qt * qt), nbrs0,
                             upper)]
    plain = graph_traverse_ref(*cpu, g.entry, max(ef, k),
                               alive=None if mask is None else mask.cpu())
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu(), b)
    assert int(kern[3].max()) == got[3]


@needs_card
def test_graph_traversal_row_alone_equals_row_in_batch(card_graph):
    g, q = card_graph
    batch = hnsw.search_batched(g, q, 10, ef_search=40, device="cuda")
    for r in (0, 17, 63):
        solo = hnsw.search_batched(g, q[r:r + 1], 10, ef_search=40,
                                   device="cuda")
        for a, b in zip(solo[:3], batch[:3]):
            assert torch.equal(a[0], b[r])


@needs_card
@pytest.mark.parametrize("tomb", [False, True], ids=["all", "tombstones"])
def test_graph_traversal_visited_matrix_in_device_memory(card_graph,
                                                         monkeypatch, tomb):
    """The visited bits in a zeroed [Q, N/32] matrix (a graph too large
    for shared memory) give the shared-memory answer."""
    g, q = card_graph
    alive = _alive(g, tomb)
    want = hnsw.search_batched(g, q, 10, ef_search=80, device="cuda",
                               alive=alive)
    monkeypatch.setattr(graph_beam_kernel, "SMEM_VISITED_MAX_N", 0)
    got = hnsw.search_batched(g, q, 10, ef_search=80, device="cuda",
                              alive=alive)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]


@needs_card
def test_graph_traversal_wide_rows_and_a_twice_listed_link(card_graph):
    """Layer-0 rows of 320 slots (wider than the block: strided reads), the
    first link of each row listed twice: the plain-hop loop's answer,
    evals and hops (both copies fresh and counted, one expansion)."""
    g, q = card_graph
    wide = np.full((g.ntotal, 320), -1, np.int32)
    wide[:, :g.links0.shape[1]] = g.links0
    wide[:, -1] = g.links0[:, 0]
    gw = hnsw.HNSWGraph(vecs=g.vecs, levels=g.levels, links0=wide,
                        links=g.links, entry=g.entry, M=g.M)
    got = hnsw.search_batched(gw, q, 10, ef_search=40, device="cuda")
    want = hnsw.search_batched(gw, q, 10, ef_search=40, device="cuda",
                               hop=graph_beam_ref)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]


@needs_card
def test_graph_traversal_limits_and_launch_counter(card_graph):
    g, q = card_graph
    vecs, vsq, nbrs0, upper = g.pack().device_arrays(g.vecs,
                                                     torch.device("cuda"))
    qt = torch.as_tensor(q, device="cuda")
    qsq = pairwise_sum(qt * qt)
    with pytest.raises(ValueError, match="ef <= 4096"):
        graph_traverse_cuda(qt, vecs, vsq, qsq, nbrs0, upper, g.entry, 4097)
    wide = torch.full((g.ntotal, 1025), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="1..1024 slots"):
        graph_traverse_cuda(qt, vecs, vsq, qsq, wide, upper, g.entry, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        graph_traverse_cuda(qt.cpu(), vecs, vsq, qsq, nbrs0, upper, g.entry,
                            8)
    graph_traverse_cuda.launches = 0
    graph_traverse_cuda(qt, vecs, vsq, qsq, nbrs0, upper, g.entry, 4096)
    graph_traverse_cuda(qt[:1], vecs, vsq, qsq[:1], nbrs0, upper[:0],
                        g.entry, 1)
    assert graph_traverse_cuda.launches == 2


def _merge_case(q_n, c, seed, pads=0.25, drained=False):
    """Candidates as the sharded merge sees them, on the card: ids unique
    per row with a share of pads (about 25%), integer values (dense ties),
    signed zeros and live ids at NEG_INF; ``drained``: the first row all
    pads."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.argsort(torch.rand(q_n, 4 * c, generator=g), dim=1)[:, :c]
    ids = ids.to(torch.int32)
    ids[torch.rand(q_n, c, generator=g) < pads] = -1
    if drained:
        ids[0] = -1
    vals = torch.randint(-3, 4, (q_n, c), generator=g).float()
    vals[torch.rand(q_n, c, generator=g) < 0.2] = -0.0
    vals[torch.rand(q_n, c, generator=g) < 0.05] = NEG_INF
    return vals.cuda(), ids.cuda()


#: The kernel's boundary cases, (C, k) -> (share of pads, first row all
#: pads): C on both sides of the narrow blocks' limit (1024), k = C at it,
#: and more pads than C - k. The other cases: 25% pads, no drained row.
MERGE_BOUNDARY = {(1024, 40): (0.25, True), (1025, 40): (0.25, True),
                  (1024, 1024): (0.25, True), (1025, 1000): (0.6, True),
                  (320, 300): (0.5, True)}


@needs_card
@pytest.mark.parametrize("q_n", [1, 257])
@pytest.mark.parametrize("c,k", [(1, 3), (6, 10), (96, 16), (320, 40),
                                 (1000, 1000), (16384, 2048),
                                 *MERGE_BOUNDARY])
def test_topk_merge_kernel_matches_plain(q_n, c, k):
    pads, drained = MERGE_BOUNDARY.get((c, k), (0.25, False))
    vals, ids = _merge_case(q_n, c, q_n + c + k, pads, drained)
    v, i = topk_merge(vals, ids, k)
    torch.cuda.synchronize()
    vr, ir = topk_merge_ref(vals, ids, k)
    assert torch.equal(i, ir)
    assert torch.equal(v.view(torch.int32), vr.view(torch.int32))


@needs_card
def test_topk_merge_kernel_limits_and_launch_counter():
    vals = torch.zeros((2, 16385), device="cuda")
    ids = torch.zeros((2, 16385), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="C <= 16384"):
        topk_merge_cuda(vals, ids, 4)
    v4, i4 = vals[:, :4].contiguous(), ids[:, :4].contiguous()
    with pytest.raises(ValueError, match="k <= C"):
        topk_merge_cuda(v4, i4, 5)
    with pytest.raises(ValueError, match="int32"):
        topk_merge_cuda(v4, i4.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        topk_merge_cuda(vals[:, :4], ids[:, :4], 2)
    topk_merge_cuda.launches = 0
    topk_merge_cuda(vals[:, :16384].contiguous(),
                    ids[:, :16384].contiguous(), 16384)
    topk_merge(vals[:, :3], ids[:, :3], 7)  # ops widens the pool to k
    assert topk_merge_cuda.launches == 2


@needs_card
@pytest.mark.parametrize("s", [1, 2, 8])
def test_sharded_flat_on_card_equals_flat_bitwise(s):
    """The contract on the card: Shard<S>,Flat == FlatIndex, bit for bit,
    on a prime-sized integer corpus; each sharded search merges once."""
    corpus = _ints(5, (5003, 16), -8, 8).numpy()
    queries = _ints(6, (37, 16), -8, 8).numpy()
    flat = api.FlatIndex().build(corpus).search(queries, 20)
    idx = api.index_factory(f"Shard{s}").build(corpus)
    topk_merge_cuda.launches = 0
    got = idx.search(queries, 20)
    assert topk_merge_cuda.launches == 1
    np.testing.assert_array_equal(got.indices, flat.indices)
    np.testing.assert_array_equal(got.scores.view(np.int32),
                                  flat.scores.view(np.int32))


@needs_card
def test_ivf_index_on_card_answers_like_the_cpu_index(tmp_path):
    """One IVF index (built on the CPU, loaded on both devices): equal ids
    and bit-equal scores on an integer corpus; two builds on the card give
    one fingerprint (the Lloyd sums take a fixed order)."""
    corpus = _ints(7, (4001, 16), -8, 8).numpy()
    queries = _ints(8, (50, 16), -8, 8).numpy()
    api.IVFFlatIndex(n_cells=32, device="cpu").build(corpus).save(
        str(tmp_path / "i"))
    cpu = api.load_index(str(tmp_path / "i"), device="cpu")
    gpu = api.load_index(str(tmp_path / "i"))
    for nprobe in (None, 24):
        p = None if nprobe is None else api.SearchParams(nprobe=nprobe)
        a, b = gpu.search(queries, 30, params=p), cpu.search(queries, 30,
                                                            params=p)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.stats == b.stats
    x = _normal(9, (20000, 64)).numpy()
    one = api.IVFFlatIndex(n_cells=64).build(x)
    two = api.IVFFlatIndex(n_cells=64).build(x)
    assert one.fingerprint() == two.fingerprint()



def _pq_case(seed, q_n, n, m, ksub, dsub, integer):
    """Queries, codebooks and uint8 codes on the card; integer values
    make every sum exact."""
    rng = np.random.default_rng(seed)
    if integer:
        q, cb = _ints(seed, (q_n, m * dsub)), _ints(seed + 1,
                                                     (m, ksub, dsub))
    else:
        q, cb = _normal(seed, (q_n, m * dsub)), _normal(seed + 1,
                                                        (m, ksub, dsub))
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m)).astype(np.uint8))
    return q.cuda(), cb.cuda(), codes.cuda()


@needs_card
@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("q_n,n,m,ksub,dsub,k", [
    (1, 1001, 8, 256, 8, 10), (257, 20011, 8, 256, 8, 320),
    (33, 5003, 1, 16, 1, 40), (7, 300, 16, 16, 4, 299),
    (5, 100, 8, 256, 2, 150), (3, 9000, 4, 64, 16, 4032),
    (2, 70, 3, 5, 3, 64)])
def test_pq_adc_kernel_matches_plain(q_n, n, m, ksub, dsub, k, integer):
    q, cb, codes = _pq_case(q_n + n, q_n, n, m, ksub, dsub, integer)
    v, i = pq_adc(q, cb, codes, k)
    torch.cuda.synchronize()
    k_eff = min(k, n)
    vr, ir = pq_adc_ref(q, cb, codes, k_eff)
    assert torch.equal(i[:, :k_eff], ir)
    assert torch.equal(v[:, :k_eff].view(torch.int32), vr.view(torch.int32))
    assert (i[:, k_eff:] == -1).all() and torch.isneginf(v[:, k_eff:]).all()


@needs_card
@pytest.mark.parametrize("k", [1, 320, 2048, 4032])
@pytest.mark.parametrize("kind", ["one_code", "ints", "float"])
def test_pq_adc_kernel_plan_branches(kind, k):
    """The new plan's branches at N = 70,001 (a pilot over every 16th row
    seeds the main pass, itself seeded at k = 1 by one over every 256th,
    unseeded at k >= 320): every row
    one code (every score tied, lists cut again and again, the lower row
    first), integer LUTs (dense ties), float; Q = 33 (three query tiles,
    the last ragged)."""
    q, cb, codes = _pq_case(k, 33, 70_001, 8, 256, 2, kind == "ints")
    if kind == "one_code":
        codes[:] = codes[0]
    v, i = pq_adc_cuda(q, cb, codes, k)
    torch.cuda.synchronize()
    vr, ir = pq_adc_ref(q, cb, codes, k)
    assert torch.equal(i, ir)
    assert torch.equal(v.view(torch.int32), vr.view(torch.int32))


@needs_card
@pytest.mark.parametrize("q_n,n,m,ksub,dsub,k,offset", [
    (5, 40_001, 16, 256, 2, 40, 0),     # 4-query tiles (a 16 KB LUT each)
    (3, 6_001, 64, 256, 1, 10, 0),      # 1-query tiles, 1024-row code tiles
    (3, 9_000, 8, 256, 2, 100, 8),      # 8-byte copies (codes off 16 B)
    (3, 9_000, 4, 64, 2, 100, 4),       # 4-byte copies
    (2, 5_003, 3, 16, 2, 64, 3),        # byte copies
    (4, 2_047, 8, 256, 2, 2_047, 0),    # N < a code tile, k = N
    (1, 1_000_003, 8, 256, 1, 2048, 0)])
def test_pq_adc_kernel_tiles_and_copies(q_n, n, m, ksub, dsub, k, offset):
    """Query tiles of 4 and of 1 (LUTs too wide for 16, and for 4 with
    2048-row code tiles), code rows copied 16, 8, 4 or 1 byte at a time
    (codes at an offset from a 16-byte boundary), a corpus shorter than one
    code tile, and one query over 1M rows."""
    q, cb, codes = _pq_case(n + k, q_n, n, m, ksub, dsub, False)
    flat = torch.empty(n * m + offset, dtype=torch.uint8, device="cuda")
    view = flat[offset:].view(n, m)
    view.copy_(codes)
    v, i = pq_adc_cuda(q, cb, view, k)
    torch.cuda.synchronize()
    vr, ir = pq_adc_ref(q, cb, codes, k)
    assert torch.equal(i, ir)
    assert torch.equal(v.view(torch.int32), vr.view(torch.int32))


@needs_card
def test_pq_adc_kernel_limits_and_launch_counter():
    q, cb, codes = _pq_case(0, 4, 5000, 8, 256, 2, False)
    with pytest.raises(ValueError, match="k <= min"):
        pq_adc_cuda(q, cb, codes, 4033)
    with pytest.raises(ValueError, match="uint8"):
        pq_adc_cuda(q, cb, codes.int(), 5)
    with pytest.raises(ValueError, match="float32"):
        pq_adc_cuda(q.double(), cb, codes, 5)
    with pytest.raises(ValueError, match="contiguous"):
        pq_adc_cuda(q, cb, codes.t().contiguous().t(), 5)
    with pytest.raises(ValueError, match="CUDA device"):
        pq_adc_cuda(q.cpu(), cb, codes, 5)
    with pytest.raises(ValueError, match="uint8"):
        pq_adc(q, cb, codes.int(), 5)  # the op never falls back
    pq_adc_cuda.launches = 0
    pq_adc_cuda(q, cb, codes, 4032)
    pq_adc(q, cb, codes, 10)
    assert pq_adc_cuda.launches == 2


def _beam_q_case(seed, mode, q_n, n, c, ksub, w, integer):
    """Hop operands on the card: sq8 operand [Q, C], pq LUT [Q, C*ksub];
    codes below 256 (sq8) or ksub (pq); about a third of the ids -1."""
    rng = np.random.default_rng(seed)
    hi = 256 if mode == "sq8" else ksub
    codes = torch.from_numpy(rng.integers(0, hi, (n, c)).astype(np.uint8))
    dop = c if mode == "sq8" else c * ksub
    if integer:
        q_op, q_bias = _ints(seed, (q_n, dop)), _ints(seed + 1, (q_n,))
        node_bias = _ints(seed + 2, (n,), 0, 9)
    else:
        q_op = _normal(seed, (q_n, dop), 0.1)
        q_bias = _normal(seed + 1, (q_n,))
        node_bias = _normal(seed + 2, (n,)).abs()
    ids = torch.from_numpy(rng.integers(-1, n, (q_n, w)).astype(np.int32))
    return [t.cuda() for t in (q_op, q_bias, codes, node_bias, ids)]


@needs_card
@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("mode,q_n,n,c,ksub,w,ef,live", [
    ("sq8", 7, 60, 16, 0, 9, 8, 2), ("sq8", 4, 25, 1, 0, 5, 4, 1),
    ("sq8", 33, 5000, 64, 0, 64, 80, 40), ("sq8", 2, 900, 64, 0, 1024, 1, 1),
    ("sq8", 3, 3000, 40, 0, 300, 4096, 100),
    ("pq", 7, 60, 8, 256, 9, 8, 2), ("pq", 5, 30, 1, 16, 1, 6, 0),
    ("pq", 33, 5000, 8, 256, 64, 80, 40), ("pq", 2, 900, 3, 64, 1024, 1, 1),
    ("pq", 3, 3000, 16, 16, 300, 4096, 100)])
def test_graph_beam_q_kernel_matches_plain(mode, q_n, n, c, ksub, w, ef,
                                           live, integer):
    q_op, q_bias, codes, node_bias, ids = _beam_q_case(
        q_n + n + c, mode, q_n, n, c, ksub, w, integer)
    bv, bi = _beam(q_n, ef, live, empty=-np.inf if live % 2 else NEG_INF)
    bv, bi = bv.cuda(), bi.cuda()
    mask = torch.from_numpy(np.random.default_rng(w).random(n) > 0.25)
    mask[:live] = True
    for db_mask in (None, mask.cuda()):
        args = (q_op, q_bias, codes, node_bias, ids, bv, bi)
        v, i = graph_beam_q(*args, db_mask=db_mask, mode=mode, ksub=ksub)
        torch.cuda.synchronize()
        vr, ir = graph_beam_q_ref(*args, db_mask=db_mask, mode=mode,
                                  ksub=ksub)
        assert torch.equal(i, ir)
        assert torch.equal(v.view(torch.int32), vr.view(torch.int32))


@needs_card
def test_graph_beam_q_kernel_limits_and_launch_counter():
    q_op, q_bias, codes, node_bias, _ = _beam_q_case(0, "pq", 2, 9, 8, 16,
                                                     1, False)

    def call(w, ef, **kw):
        ids = torch.zeros((2, w), dtype=torch.int32, device="cuda")
        bv = torch.full((2, ef), NEG_INF, device="cuda")
        bi = torch.full((2, ef), -1, dtype=torch.int32, device="cuda")
        args = dict(q_op=q_op, q_bias=q_bias, codes=codes,
                    node_bias=node_bias, nbr_ids=ids, beam_v=bv, beam_i=bi)
        args.update(kw)
        return graph_beam_q_cuda(mode="pq", ksub=16, **args)

    with pytest.raises(ValueError, match="W <= 1024"):
        call(1025, 8)
    with pytest.raises(ValueError, match="ef <= 4096"):
        call(8, 4097)
    with pytest.raises(ValueError, match="uint8"):
        call(8, 8, codes=codes.int())
    with pytest.raises(ValueError, match="contiguous"):
        call(8, 8, q_op=q_op.t().contiguous().t())
    with pytest.raises(ValueError, match="m\\*ksub"):
        call(8, 8, q_op=q_op[:, :64].contiguous())
    with pytest.raises(ValueError, match="mode"):
        graph_beam_q(q_op, q_bias, codes, node_bias,
                     torch.zeros((2, 3), dtype=torch.int32, device="cuda"),
                     torch.zeros((2, 4), device="cuda"),
                     torch.zeros((2, 4), dtype=torch.int32, device="cuda"),
                     mode="fp4")
    graph_beam_q_cuda.launches = 0
    call(1024, 4096)
    call(1, 1)
    assert graph_beam_q_cuda.launches == 2


@needs_card
@pytest.mark.parametrize("spec", ["SQ8", "PQ8x8", "IVF32,SQ8", "IVF32,PQ8x8"])
def test_quantized_index_on_card_answers_like_the_cpu_index(spec, tmp_path):
    """One quantized index (built on the CPU, loaded on both devices):
    equal ids and bit-equal scores. Every dim spans 0..255, so the SQ8
    step is 1 and its matmuls are exact on integer queries; the PQ LUT and
    sums are elementwise trees. The flat PQ scan goes through the
    kernel."""
    corpus = _ints(10, (4001, 16), 0, 256).numpy()
    corpus[0], corpus[1] = 0.0, 255.0
    queries = _ints(11, (50, 16), 0, 256).numpy()
    api.index_factory(spec, device="cpu").build(corpus).save(
        str(tmp_path / "i"))
    cpu = api.load_index(str(tmp_path / "i"), device="cpu")
    gpu = api.load_index(str(tmp_path / "i"))
    pq_adc_cuda.launches = 0
    alive = np.random.default_rng(0).random(4001) > 0.1
    for al in (None, alive):
        a, b = gpu.search(queries, 30, alive=al), cpu.search(queries, 30,
                                                            alive=al)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert pq_adc_cuda.launches == (2 if spec == "PQ8x8" else 0)
    assert gpu.fingerprint() == cpu.fingerprint()


@needs_card
@pytest.mark.parametrize("quant", ["sq8", "pq"])
def test_quantized_hnsw_on_card_answers_like_the_cpu_index(quant, tmp_path):
    """A quantized graph built on the CPU, loaded on both devices: equal
    ids and bit-equal scores (the hop's sums, the LUT and the SQ8 operands
    are elementwise trees on both devices); a search one launch of the
    quantized traversal, no hop kernel; a lone query answers as in its
    batch."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(8, 32)) * 4
    corpus = (centers[rng.integers(0, 8, 3000)]
              + rng.normal(size=(3000, 32))).astype(np.float32)
    queries = corpus[rng.integers(0, 3000, 200)] + 0.01
    api.HNSWIndex(m=8, ef_construction=40, quant=quant, pq_m=8,
                  device="cpu").build(corpus).save(str(tmp_path / "g"))
    cpu = api.load_index(str(tmp_path / "g"), device="cpu")
    gpu = api.load_index(str(tmp_path / "g"))
    graph_beam_q_cuda.launches = graph_beam_cuda.launches = 0
    graph_traverse_q_cuda.launches = graph_traverse_cuda.launches = 0
    got = gpu.search(queries, 10)
    assert graph_traverse_q_cuda.launches == 1
    assert (graph_beam_q_cuda.launches, graph_beam_cuda.launches,
            graph_traverse_cuda.launches) == (0, 0, 0)
    want = cpu.search(queries, 10)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.stats == want.stats
    solo = gpu.search(queries[3:4], 10)
    np.testing.assert_array_equal(solo.indices[0], got.indices[3])
    np.testing.assert_array_equal(solo.scores[0], got.scores[3])


def _codec_graph(card_graph, quant):
    """The card graph with an SQ8 or PQ8x8 payload (trained on the card)
    and its quantized traversal's operands on the card."""
    g, q = card_graph
    gq = hnsw.HNSWGraph(vecs=g.vecs, levels=g.levels, links0=g.links0,
                        links=g.links, entry=g.entry, M=g.M)
    gq.codec = hnsw.make_graph_codes(g.vecs, quant, m=8, seed=0)
    dev = torch.device("cuda")
    _, _, nbrs0, upper = gq.pack().device_arrays(gq.vecs, dev)
    codes, node_bias = gq.codec.device_arrays(dev)[:2]
    qt = torch.as_tensor(q, device="cuda")
    q_op, q_bias = gq.codec.query_operands(qt, pairwise_sum(qt * qt))
    return gq, q, (q_op.contiguous(), q_bias.contiguous(), codes, node_bias,
                   nbrs0, upper)


@needs_card
@pytest.mark.parametrize("tomb", [False, True], ids=["all", "tombstones"])
@pytest.mark.parametrize("ef", [1, 10, 80, 4096])
@pytest.mark.parametrize("quant", ["sq8", "pq"])
def test_graph_traversal_q_kernel_equals_plain_hop_loop(card_graph, quant,
                                                        ef, tomb):
    """A quantized search is one launch of the quantized traversal (no hop
    kernel, no float32 kernel); ids, scores (bit-equal), evals and hops
    equal to the batched loop of plain quantized hops, and to the
    per-query plain model (each row's hops included)."""
    gq, q, ops = _codec_graph(card_graph, quant)
    alive, k = _alive(gq, tomb), min(10, ef)
    for fn in (graph_traverse_q_cuda, graph_beam_q_cuda, graph_traverse_cuda,
               graph_beam_cuda):
        fn.launches = 0
    got = hnsw.search_batched(gq, q, k, ef_search=ef, device="cuda",
                              alive=alive)
    assert (graph_traverse_q_cuda.launches, graph_beam_q_cuda.launches,
            graph_traverse_cuda.launches, graph_beam_cuda.launches) == \
        (1, 0, 0, 0)
    want = hnsw.search_batched(gq, q, k, ef_search=ef, device="cuda",
                               alive=alive, hop=graph_beam_q_ref)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]
    mask = None if alive is None else torch.as_tensor(alive, device="cuda")
    mode, ksub = gq.codec.kind, gq.codec.ksub
    kern = graph_traverse_q_cuda(*ops, gq.entry, max(ef, k), mode, ksub,
                                 alive=mask)
    plain = graph_traverse_q_ref(*(t.cpu() for t in ops), gq.entry,
                                 max(ef, k), mode, ksub,
                                 alive=None if mask is None else mask.cpu())
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu(), b)
    assert int(kern[3].max()) == got[3]


@needs_card
@pytest.mark.parametrize("quant", ["sq8", "pq"])
def test_graph_traversal_q_visited_matrix_and_row_alone(card_graph,
                                                        monkeypatch, quant):
    """The visited bits in a zeroed [Q, N/32] matrix give the
    shared-memory answer, and a query alone answers as its batch row."""
    gq, q, _ = _codec_graph(card_graph, quant)
    alive = _alive(gq, True)
    want = hnsw.search_batched(gq, q, 10, ef_search=80, device="cuda",
                               alive=alive)
    for r in (0, 17, 63):
        solo = hnsw.search_batched(gq, q[r:r + 1], 10, ef_search=80,
                                   device="cuda", alive=alive)
        for a, b in zip(solo[:3], want[:3]):
            assert torch.equal(a[0], b[r])
    monkeypatch.setattr(graph_beam_kernel, "SMEM_VISITED_MAX_N", 0)
    got = hnsw.search_batched(gq, q, 10, ef_search=80, device="cuda",
                              alive=alive)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]


@needs_card
def test_graph_traversal_q_limits_and_launch_counter(card_graph):
    gq, _, (q_op, q_bias, codes, node_bias, nbrs0, upper) = _codec_graph(
        card_graph, "pq")
    ksub = gq.codec.ksub

    def call(*args, **kw):
        return graph_traverse_q_cuda(*args, **{"mode": "pq", "ksub": ksub,
                                               **kw})

    with pytest.raises(ValueError, match="ef <= 4096"):
        call(q_op, q_bias, codes, node_bias, nbrs0, upper, gq.entry, 4097)
    wide = torch.full((gq.ntotal, 1025), -1, dtype=torch.int32,
                      device="cuda")
    with pytest.raises(ValueError, match="1..1024 slots"):
        call(q_op, q_bias, codes, node_bias, wide, upper, gq.entry, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        call(q_op.cpu(), q_bias, codes, node_bias, nbrs0, upper, gq.entry, 8)
    with pytest.raises(ValueError, match="uint8"):
        call(q_op, q_bias, codes.int(), node_bias, nbrs0, upper, gq.entry, 8)
    with pytest.raises(ValueError, match="m\\*ksub"):
        call(q_op[:, :64].contiguous(), q_bias, codes, node_bias, nbrs0,
             upper, gq.entry, 8)
    with pytest.raises(ValueError, match="mode"):
        call(q_op, q_bias, codes, node_bias, nbrs0, upper, gq.entry, 8,
             mode="fp4")
    with pytest.raises(ValueError, match="out of range"):
        call(q_op, q_bias, codes, node_bias, nbrs0, upper, gq.ntotal, 8)
    graph_traverse_q_cuda.launches = 0
    call(q_op, q_bias, codes, node_bias, nbrs0, upper, gq.entry, 4096)
    call(q_op[:1], q_bias[:1], codes, node_bias, nbrs0, upper[:0], gq.entry,
         1)
    assert graph_traverse_q_cuda.launches == 2


# ---------------------------------------------------------------------------
# embedding_bag: adds the plain version's rows in its slot order, so the
# two agree bit for bit
# ---------------------------------------------------------------------------
def _bag_case(v, d, b, l, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((v, d), generator=g).to(dtype)
    ids = torch.randint(-3, v + 3, (b, l), generator=g, dtype=torch.int32)
    lens = torch.randint(-1, l + 4, (b,), generator=g, dtype=torch.int32)
    return table.cuda(), ids.cuda(), lens.cuda()


@needs_card
@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,l", [(1000, 256, 513, 50), (13, 5, 7, 3),
                                     (10, 1, 4, 5), (97, 24, 33, 37),
                                     (50, 96, 1, 1)])
def test_embedding_bag_kernel_matches_plain_bitwise(v, d, b, l, dtype, mode):
    table, ids, lens = _bag_case(v, d, b, l, dtype)
    got = embedding_bag_cuda(table, ids, lens, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, embedding_bag_ref(table, ids, lens, mode))


@needs_card
def test_embedding_bag_kernel_limits_and_launch_counter():
    table, ids, lens = _bag_case(20, 8, 6, 4, torch.float32)
    before = embedding_bag_cuda.launches
    embedding_bag(table, ids, lens, "mean")
    embedding_bag(table[:, :5].contiguous(), ids, lens, "sum")
    assert embedding_bag_cuda.launches == before + 2
    embedding_bag_cuda(table, ids[:0], lens[:0], "mean")   # no bags: no launch
    assert embedding_bag_cuda.launches == before + 2
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_cuda(table, ids.long(), lens, "mean")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        embedding_bag_cuda(table.half(), ids, lens, "mean")
    with pytest.raises(ValueError, match="CUDA device"):
        embedding_bag_cuda(table.cpu(), ids, lens, "mean")
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_cuda(table, ids, lens, "max")
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_cuda(table[:, ::2], ids, lens, "mean")


# ---------------------------------------------------------------------------
# embedding_bag_bwd: sums each row's slots in ascending (b, l) from zero, as
# its plain version does, so the two agree bit for bit
# ---------------------------------------------------------------------------
def _bwd_case(kind, v, d, b, l, seed=0):
    g = torch.Generator().manual_seed(seed)
    grad = torch.randn((b, d), generator=g)
    ids = torch.randint(0, v, (b, l), generator=g, dtype=torch.int32)
    lens = torch.randint(1, l + 1, (b,), generator=g, dtype=torch.int32)
    if kind == "ragged":
        lens = torch.randint(-1, l + 4, (b,), generator=g, dtype=torch.int32)
    elif kind == "tied":                  # a few ids, runs of hundreds
        ids = torch.randint(0, 3, (b, l), generator=g, dtype=torch.int32)
    elif kind == "clipped":
        ids = torch.randint(-v, 2 * v, (b, l), generator=g,
                            dtype=torch.int32)
    elif kind == "all_pad":
        lens.zero_()
    elif kind == "bag_of_one":
        lens.fill_(1)
    return grad.cuda(), ids.cuda(), lens.cuda()


@needs_card
@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("kind,v,d,b,l", [
    ("ragged", 1000, 256, 513, 50), ("ragged", 13, 5, 7, 3),
    ("ragged", 97, 24, 33, 37), ("tied", 50, 96, 300, 8),
    ("clipped", 40, 33, 64, 6), ("all_pad", 20, 8, 6, 4),
    ("bag_of_one", 128_256, 64, 4096, 1),
    ("ragged", 10_000_000, 256, 2048, 50)])
def test_embedding_bag_bwd_kernel_matches_plain_bitwise(kind, v, d, b, l,
                                                        mode):
    grad, ids, lens = _bwd_case(kind, v, d, b, l)
    got = embedding_bag_bwd_cuda(grad, ids, lens, mode, v)
    torch.cuda.synchronize()
    want = embedding_bag_bwd_ref(grad, ids, lens, mode, v)
    assert torch.equal(got, want)
    if kind == "all_pad":
        assert not bool(got.any())


@needs_card
def test_embedding_bag_bwd_kernel_limits_and_launch_counter():
    grad, ids, lens = _bwd_case("ragged", 20, 8, 6, 4)
    before = embedding_bag_bwd_cuda.launches
    embedding_bag_bwd(grad, ids, lens, "mean", 20)
    embedding_bag_bwd(grad[:, :5].contiguous(), ids.long(), lens, "sum", 20)
    assert embedding_bag_bwd_cuda.launches == before + 2
    out = embedding_bag_bwd_cuda(grad[:0], ids[:0], lens[:0], "sum", 20)
    assert embedding_bag_bwd_cuda.launches == before + 2   # nothing to sum
    assert out.shape == (20, 8) and not bool(out.any())
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_bwd_cuda(grad, ids.long(), lens, "sum", 20)
    with pytest.raises(ValueError, match="float32 gradient"):
        embedding_bag_bwd_cuda(grad.half(), ids, lens, "sum", 20)
    with pytest.raises(ValueError, match="CUDA device"):
        embedding_bag_bwd_cuda(grad.cpu(), ids, lens, "sum", 20)
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_bwd_cuda(grad, ids, lens, "max", 20)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_bwd_cuda(grad[:, ::2], ids, lens, "sum", 20)
    with pytest.raises(ValueError, match="shapes"):
        embedding_bag_bwd_cuda(grad[:3], ids, lens, "sum", 20)


# ---------------------------------------------------------------------------
# flash_decode: split over the KV axis and merged, so float32 sums in
# another order than the plain version: within 1e-5 of the largest
# ---------------------------------------------------------------------------
def _decode_case(b, kh, g, dh, s, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, kh, g, dh), generator=gen)
    k = torch.randn((b, s, kh, dh), generator=gen).to(dtype)
    v = torch.randn((b, s, kh, dh), generator=gen).to(dtype)
    return q.cuda(), k.cuda(), v.cuda()


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kh,g,dh,s,cur", [
    (2, 2, 4, 16, 64, 37), (4, 4, 1, 32, 128, 128), (1, 1, 8, 64, 256, 1),
    (3, 8, 2, 16, 96, 50), (2, 2, 2, 8, 50, 37), (2, 1, 2, 1, 33, 20),
    (1, 8, 4, 64, 70001, 69990), (4, 8, 4, 64, 4096, 4000),
    (1, 2, 3, 128, 300, 299), (2, 2, 2, 6, 40, 0), (1, 2, 2, 12, 40, 77),
    (1, 1, 32, 128, 260, 200)])
def test_flash_decode_kernel_matches_plain(b, kh, g, dh, s, cur, dtype):
    q, k, v = _decode_case(b, kh, g, dh, s, dtype)
    cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
    got = flash_decode_cuda(q, k, v, cl)
    torch.cuda.synchronize()
    _close_decode(got, flash_decode_ref(q, k, v, cl))
    if cur <= 0:
        assert torch.all(got == 0)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kh,g,dh,s,cur", [
    (2, 8, 4, 64, 4096, 3001), (1, 2, 3, 128, 300, 299),
    (1, 1, 32, 128, 260, 200), (2, 2, 2, 6, 40, 33), (2, 1, 2, 1, 33, 20)])
def test_flash_decode_kernel_unaligned_caches(b, kh, g, dh, s, cur, dtype):
    """Caches one element past a 16-byte boundary take the scalar variant."""
    q, k, v = _decode_case(b, kh, g, dh, s, dtype, seed=1)
    k, v = _offset_view(k), _offset_view(v)
    cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
    got = flash_decode_cuda(q, k, v, cl)
    torch.cuda.synchronize()
    _close_decode(got, flash_decode_ref(q, k, v, cl))


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_splits_end_at_the_live_length(dtype):
    """The live length one before, at and one past a split's end, and in
    the middle of a tile of the third split."""
    from repro_torch.kernels.flash_decode.kernel import TILE, split_plan

    b, kh, g, dh, s = 1, 8, 4, 64, 20000
    split, nsplit = split_plan(b, kh, s, TILE)
    assert nsplit >= 3
    q, k, v = _decode_case(b, kh, g, dh, s, dtype, seed=2)
    for cur in (split - 1, split, split + 1, 2 * split + 37):
        cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
        got = flash_decode_cuda(q, k, v, cl)
        torch.cuda.synchronize()
        _close_decode(got, flash_decode_ref(q, k, v, cl))


@needs_card
def test_flash_decode_reads_the_length_on_the_device():
    """One launch sequence, the length changed on the device between two
    calls: no host value is needed."""
    q, k, v = _decode_case(2, 8, 4, 64, 5000, torch.bfloat16)
    cl = torch.tensor(1000, dtype=torch.int32, device="cuda")
    a = flash_decode(q, k, v, cl)
    cl += 2345
    b = flash_decode(q, k, v, cl)
    torch.cuda.synchronize()
    _close_decode(a, flash_decode_ref(q, k, v, 1000))
    _close_decode(b, flash_decode_ref(q, k, v, 3345))


@needs_card
def test_flash_decode_kernel_limits_and_launch_counter():
    q, k, v = _decode_case(1, 2, 2, 16, 64, torch.float32)
    cl = torch.tensor(10, dtype=torch.int32, device="cuda")
    before = flash_decode_cuda.launches
    flash_decode(q, k, v, 10)
    flash_decode(q, k.bfloat16(), v.bfloat16(), cl)
    assert flash_decode_cuda.launches == before + 2
    with pytest.raises(ValueError, match="dh <= 128"):
        big = torch.zeros((1, 1, 1, 129), device="cuda")
        flash_decode_cuda(big, torch.zeros((1, 4, 1, 129), device="cuda"),
                          torch.zeros((1, 4, 1, 129), device="cuda"), cl)
    with pytest.raises(ValueError, match="g \\* dh"):
        wide = torch.zeros((1, 1, 64, 128), device="cuda")
        cache = torch.zeros((1, 4, 1, 128), device="cuda")
        flash_decode_cuda(wide, cache, cache, cl)
    with pytest.raises(ValueError, match="one dtype"):
        flash_decode_cuda(q, k, v.bfloat16(), cl)
    with pytest.raises(ValueError, match="int32"):
        flash_decode_cuda(q, k, v, cl.long())
    with pytest.raises(ValueError, match="shapes"):
        flash_decode_cuda(q, k[:, :, :1].contiguous(), v, cl)


# ---------------------------------------------------------------------------
# the model paths on the card against the CPU
# ---------------------------------------------------------------------------
@needs_card
def test_two_tower_on_card_answers_like_the_cpu(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.configs.reduce import reduce_cell, reduce_config
    from repro_torch.models import registry
    from repro_torch.models.registry import build_cell

    cfg = reduce_config(*get_arch("two-tower-retrieval"))
    monkeypatch.setattr(registry, "get_arch", lambda arch: (cfg, "recsys"))
    cell = build_cell("two-tower-retrieval", "serve_p99", "cuda")
    cell_cpu = build_cell("two-tower-retrieval", "serve_p99", "cpu")
    params = cell.init(0)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    (batch,) = cell.make_inputs(3)
    before = embedding_bag_cuda.launches
    got = cell.fn(params, batch)
    assert embedding_bag_cuda.launches == before + 1
    want = cell_cpu.fn(params_cpu, {k: v.cpu() for k, v in batch.items()})
    assert float((got.cpu() - want).abs().max()) < 1e-2
    retr = build_cell("two-tower-retrieval",
                      reduce_cell(cell.cell.replace(kind="retrieval",
                                                    n_candidates=512,
                                                    global_batch=1),
                                  "recsys"), "cuda")
    (batch,) = retr.make_inputs(4)
    vals, ids = retr.fn(params, batch)
    assert vals.shape == (100,) and torch.all(vals[:-1] >= vals[1:])


@needs_card
def test_llama_decode_on_card_answers_like_the_cpu():
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.models.transformer import model as tm

    cfg = dataclasses.replace(reduce_config(*get_arch("llama3.2-1b")),
                              compute_dtype="float32")
    params = tm.init(cfg, 0, "cuda")
    params_cpu = {k: ({n: t.cpu() for n, t in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (3, 24),
                         generator=torch.Generator().manual_seed(0))
    _, _, st = tm.prefill(params, toks[:, :20].cuda(), cfg, max_len=32)
    _, _, st_cpu = tm.prefill(params_cpu, toks[:, :20], cfg, max_len=32)
    before = flash_decode_cuda.launches
    for i in range(20, 24):
        lg, _, st = tm.decode_step(params, st, toks[:, i].cuda(), cfg)
        lg_cpu, _, st_cpu = tm.decode_step(params_cpu, st_cpu, toks[:, i],
                                           cfg)
        _close(lg.cpu(), lg_cpu)
    assert flash_decode_cuda.launches == before + 4 * cfg.n_layers
    assert int(st.length) == 24


def _train_cell(arch, monkeypatch, device):
    from repro_torch.configs import get_arch, get_shapes
    from repro_torch.configs.reduce import reduce_cell, reduce_config
    from repro_torch.models import registry

    cfg, fam = get_arch(arch)
    small = reduce_config(cfg, fam)
    monkeypatch.setattr(registry, "get_arch", lambda a: (small, fam))
    train = [c for c in get_shapes(arch) if c.kind == "train"][0]
    return registry.build_cell(arch, reduce_cell(train, fam), device)


def _plain_bag(monkeypatch):
    monkeypatch.setattr(bag_ops, "embedding_bag", embedding_bag_ref)
    monkeypatch.setattr(bag_ops, "embedding_bag_bwd", embedding_bag_bwd_ref)


def _flat(tree):
    from repro_torch.pytree import flatten_with_path

    return dict(flatten_with_path(tree))


@needs_card
@pytest.mark.parametrize("arch", ["two-tower-retrieval", "llama3.2-1b"])
def test_train_step_on_card_equals_the_plain_path(arch, monkeypatch):
    """A reduced train step on the card with the kernels gives the bits of
    the same step with their plain versions (the forward bag, the
    lookups' and the bag's backward), params and moments."""
    cell = _train_cell(arch, monkeypatch, "cuda")
    params = cell.init(0)
    opt_state = cell.init_opt(params)
    (batch,) = cell.make_inputs(1)
    before = embedding_bag_bwd_cuda.launches
    p1, s1, m1 = cell.fn(params, opt_state, batch)
    assert embedding_bag_bwd_cuda.launches - before == (
        3 if arch == "two-tower-retrieval" else 1)
    with monkeypatch.context() as mp:
        _plain_bag(mp)
        p2, s2, m2 = cell.fn(params, opt_state, batch)
    assert embedding_bag_bwd_cuda.launches - before == (
        3 if arch == "two-tower-retrieval" else 1)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in ((p1, p2), (s1.m, s2.m), (s1.v, s2.v)):
        fa, fb = _flat(a), _flat(b)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)


@needs_card
@pytest.mark.parametrize("arch", ["two-tower-retrieval", "llama3.2-1b"])
def test_train_steps_on_card_are_deterministic(arch, monkeypatch):
    """Two runs of three steps from one state give the same bits (params
    and moments): no step sums in a varying order."""
    cell = _train_cell(arch, monkeypatch, "cuda")
    runs = []
    for _ in range(2):
        params = cell.init(0)
        opt_state = cell.init_opt(params)
        for step in range(3):
            (batch,) = cell.make_inputs(step)
            params, opt_state, _ = cell.fn(params, opt_state, batch)
        runs.append((_flat(params), _flat(opt_state.m), _flat(opt_state.v)))
    for a, b in zip(*runs):
        assert all(torch.equal(a[k], b[k]) for k in a)


@needs_card
def test_train_step_on_card_is_close_to_the_cpu(monkeypatch):
    """The reduced two-tower's loss and gradients on the card against the
    CPU's: within float32 rounding at compute_dtype float32."""
    import dataclasses

    from repro_torch.models.recsys import two_tower as tt

    cell = _train_cell("two-tower-retrieval", monkeypatch, "cuda")
    cfg = dataclasses.replace(cell.cfg, compute_dtype="float32")
    params = cell.init(0)
    (batch,) = cell.make_inputs(2)
    out = []
    for dev in ("cuda", "cpu"):
        leaves = {k: v.to(dev).detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, _ = tt.loss_fn(leaves, {k: v.to(dev)
                                      for k, v in batch.items()}, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append((loss.detach().cpu(), [g.cpu() for g in grads]))
    (lc, gc), (lp, gp) = out
    assert abs(float(lc) - float(lp)) <= 1e-4 * abs(float(lp))
    for a, b in zip(gc, gp):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1e-12, float(b.abs().max()))


# ---------------------------------------------------------------------------
# the Table 1 baselines, the IVF probe's tie order and live mutation
# ---------------------------------------------------------------------------
@needs_card
@pytest.mark.parametrize("name", ["pca", "rp", "mds", "isomap", "umap"])
def test_baseline_reducer_on_card_answers_like_the_cpu(name):
    """A baseline fitted on the card equals the CPU's fit (host numpy, and
    Isomap's min-plus geodesics bit-equal on both devices); its transform
    through the ``rae_encode`` kernel is within TOL of the CPU's plain
    version. UMAP's kNN average is plain torch on both devices, its
    float32 distances rounded otherwise on the card: a row whose k-th and
    (k+1)-th train rows lie closer than the two devices' rounding bound
    may average either set, and is held to one of them; every other row
    to the CPU's answer."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(700, 48)).astype(np.float32)
    kw = {"max_train": 300} if name in ("mds", "isomap", "umap") else {}
    if name == "umap":
        kw["n_epochs"] = 10
    cpu = api.make_reducer(name, 16, device="cpu", **kw).fit(x[:500])
    card = api.make_reducer(name, 16, device="cuda", **kw).fit(x[:500])
    assert card.fingerprint() == cpu.fingerprint()
    want = cpu.transform(x[500:])            # rows the fits never saw
    before = rae_encode_cuda.launches
    got = card.transform(x[500:])
    assert got.device.type == "cuda"
    assert rae_encode_cuda.launches - before == (0 if name == "umap" else 1)
    scale = max(1.0, float(want.abs().max()))
    err = (got.cpu() - want).abs().max(dim=1).values.numpy()
    if name != "umap":
        assert (err <= TOL * scale).all(), err.max()
        return
    um = card._impl
    q, t = x[500:].astype(np.float64), um.train_x_.astype(np.float64)
    k = um.n_neighbors
    sq, st = (q * q).sum(1)[:, None], (t * t).sum(1)[None, :]
    d = np.sqrt(np.maximum(sq - 2 * q @ t.T + st, 0))
    order = np.argsort(d, axis=1, kind="stable")
    rows = np.arange(len(q))
    gap = d[rows, order[:, k]] - d[rows, order[:, k - 1]]
    # each device's float32 d^2 errs by at most (48 + 2) ulps of the sum of
    # |terms|, so its d by that over 2d; a swap needs both ends to move
    err_d2 = 50 * 2.0 ** -24 * (sq + 2 * np.sqrt(sq * st) + st)
    err_d = err_d2 / (2 * np.maximum(d, 1e-6))
    bound = 2 * (err_d[rows, order[:, k]] + err_d[rows, order[:, k - 1]])
    near = gap <= bound
    far_bad = np.flatnonzero(~near & (err > TOL * scale))
    assert far_bad.size == 0, [(int(r), float(gap[r]), float(bound[r]),
                                float(err[r])) for r in far_bad]
    emb = um.embedding_.astype(np.float64)
    for r in np.flatnonzero(near):
        sets = [order[r, :k],
                np.append(order[r, :k - 1], order[r, k])]
        outs = []
        for nb in sets:
            w = 1.0 / np.maximum(d[r, nb], 1e-6)
            outs.append((w / w.sum()) @ emb[nb])
        dev = [np.abs(got[r].cpu().numpy() - o).max() for o in outs]
        assert min(dev) <= TOL * scale, (int(r), float(gap[r]), dev)


@needs_card
def test_isomap_geodesics_on_card_bit_equal_to_cpu():
    from repro_torch.core import baselines

    rng = np.random.default_rng(4)
    x = rng.normal(size=(400, 24)).astype(np.float32)
    x[200:] += 50.0                            # two components
    g = baselines.Isomap(8, n_neighbors=6).knn_graph(x)
    card = baselines.geodesics(g, "cuda")
    assert np.array_equal(card, baselines.geodesics(g, "cpu"))
    assert np.isinf(card).any()


@needs_card
def test_ivf_probe_tie_order_on_card_equals_the_cpu():
    from repro_torch.search import ivf as ivf_lib

    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.integers(-4, 4, (33, 3000)).astype(np.float32))
    s[:, ::7] = float("-inf")
    s[0, 5] = -0.0
    ids = torch.from_numpy(rng.permutation(3000 * 33).reshape(33, 3000)
                           .astype(np.int32) - 1)
    for k in (1, 40, 2048):
        cv, ci = ivf_lib.topk_by_score_then_id(s, ids, k)
        gv, gi = ivf_lib.topk_by_score_then_id(s.cuda(), ids.cuda(), k)
        assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv)


def _uploads(monkeypatch):
    calls = {"n": 0}
    for name in ("as_tensor", "tensor", "from_numpy"):
        orig = getattr(torch, name)

        def wrapped(data, *a, _orig=orig, **kw):
            if not isinstance(data, torch.Tensor):
                calls["n"] += 1
            return _orig(data, *a, **kw)

        monkeypatch.setattr(torch, name, wrapped)
    return calls


@needs_card
@pytest.mark.parametrize("spec", ["Mut,Flat", "Mut,IVF16", "Mut,HNSW8",
                                  "Mut,Shard2,Flat", "Mut,HNSW8,SQ8",
                                  "Mut,RAE8,Flat,Rerank2"])
def test_mutable_stack_on_card_answers_like_the_cpu(spec, monkeypatch):
    """The same adds and deletes on the card and on the CPU: the same
    answers on an integer corpus (the masked kernels against the plain
    versions), no tombstone surfacing, and a masked search uploading no
    more host arrays than a clean one."""
    rng = np.random.default_rng(6)
    x = rng.integers(-8, 8, (300, 16)).astype(np.float32)
    new = rng.integers(-8, 8, (12, 16)).astype(np.float32)
    kw = dict(index_kw={"ef_construction": 40} if "HNSW" in spec else None,
              reducer_kw={"steps": 30} if "RAE" in spec else None)
    stacks = {}
    for dev in ("cpu", "cuda"):
        ix = api.index_factory(spec, device=dev, **kw).build(x)
        if "RAE" in spec and dev == "cuda":
            # one fit for both devices: the trainers sum in other orders
            ix._inner.reducer.params_ = {
                k: v.cuda() for k, v in
                stacks["cpu"]._inner.reducer.params_.items()}
            ix.build(x)
        ix.add(new)
        ix.delete([3, 4, 301, 150])
        stacks[dev] = ix
    q = np.concatenate([x[:8], new[:4]])
    cpu, card = stacks["cpu"].search(q, 10), stacks["cuda"].search(q, 10)
    assert not np.isin(card.indices, [3, 4, 301, 150]).any()
    if spec not in ("Mut,IVF16", "Mut,RAE8,Flat,Rerank2"):
        # k-means and the encoder round in other orders on the card
        np.testing.assert_array_equal(card.indices, cpu.indices)
        np.testing.assert_array_equal(card.scores, cpu.scores)
    clean = api.index_factory(spec, device="cuda", **kw).build(x)
    calls = _uploads(monkeypatch)
    clean.search(q, 10)
    n_clean, calls["n"] = calls["n"], 0
    stacks["cuda"].search(q, 10)
    assert calls["n"] <= n_clean


# ---------------------------------------------------------------------------
# serving on the card: a row's answer never depends on its batch-mates
# ---------------------------------------------------------------------------
SERVE_SPECS = ("RAE64,Flat,Rerank4", "RAE64,IVF256,Rerank4",
               "RAE64,PQ8x8,Rerank4")


@pytest.fixture(scope="module")
def serve_data():
    """A float corpus (so a reduction's order would show in the bits), 32
    noisy queries, and one RAE fit shared by the served stacks."""
    from repro_torch.data import synthetic

    x = synthetic.embedding_corpus(6000, 128, n_clusters=16, intrinsic=32,
                                   seed=3)
    rng = np.random.default_rng(4)
    q = (x[rng.choice(len(x), 32, replace=False)]
         + 0.05 * rng.standard_normal((32, 128))).astype(np.float32)
    red = api.make_reducer("rae", 64, steps=200, seed=0, device="cuda")
    red.fit(x)
    return x, q, red


def _served(spec, serve_data):
    x, _, red = serve_data
    ix = api.index_factory(spec, device="cuda")
    ix.reducer = red
    return ix.build(x)


def _requests(qs, k):
    return [_Request(q=q, k=k, future=None) for q in qs]


@needs_card
@pytest.mark.parametrize("spec", SERVE_SPECS)
def test_engine_rows_on_card_equal_their_lone_answers(spec, serve_data):
    """Every batch size 1-32, padded to its bucket by the engine: each row
    equals, ids and score bits, the stack's search of that query alone."""
    _, q, _ = serve_data
    ix = _served(spec, serve_data)
    eng = SearchEngine(ix, max_batch=32, cache_size=0)
    lone = [ix.search(q[i:i + 1], 10) for i in range(len(q))]
    for size in range(1, 33):
        for i, r in enumerate(eng._run_batch(10, _requests(q[:size], 10))):
            np.testing.assert_array_equal(r.indices[0], lone[i].indices[0])
            assert r.scores.tobytes() == lone[i].scores[:1].tobytes(), \
                (spec, size, i)


@needs_card
@pytest.mark.parametrize("threshold", [0.02, 1.5])
def test_engine_escalated_rows_on_card_equal_alone_and_in_batch(threshold,
                                                                serve_data):
    """A row escalated alone answers bit for bit as the same row escalated
    inside its batch (pass 2 padded to the smallest covering bucket)."""
    from repro_torch.api import SearchParams

    _, q, _ = serve_data
    ix = _served("RAE64,IVF256,Rerank4", serve_data)
    eng = SearchEngine(ix, max_batch=32, cache_size=0,
                       params=SearchParams(nprobe=8),
                       escalation=EscalationPolicy(delta=3,
                                                   threshold=threshold))
    batch = eng._run_batch(10, _requests(q, 10))
    n_esc = 0
    for i in range(len(q)):
        solo = eng._run_batch(10, _requests(q[i:i + 1], 10))[0]
        assert solo.stats["escalated"] == batch[i].stats["escalated"]
        n_esc += int(solo.stats["escalated"])
        np.testing.assert_array_equal(solo.indices, batch[i].indices)
        assert solo.scores.tobytes() == batch[i].scores.tobytes()
    if threshold > 1:
        assert n_esc == len(q)


@needs_card
def test_engine_on_card_pays_no_cold_path_after_warmup(serve_data):
    """After warmup(), a storm of every batch size and both served k pays
    no kernel build or library load."""
    _, q, _ = serve_data
    for spec in SERVE_SPECS:
        ix = _served(spec, serve_data)
        eng = SearchEngine(ix, max_batch=32, cache_size=0).warmup(ks=(5, 10))
        rng = np.random.default_rng(0)
        with no_retrace(budget=0, what=f"{spec} storm") as used:
            for size in rng.integers(1, 33, 24):
                k = int(rng.choice([5, 10]))
                eng._run_batch(k, _requests(q[:size], k))
            assert used() == 0


@needs_card
def test_hot_swap_on_card_under_load_drops_nothing():
    """Clients query their own rows while a Flat index on the card is
    swapped for a superset: every reply is the exact self-hit."""
    rng = np.random.default_rng(8)
    x = rng.integers(-8, 8, (4096, 32)).astype(np.float32)
    bigger = np.concatenate([x, rng.integers(-8, 8, (64, 32)).astype(
        np.float32)])
    n_clients, reps = 16, 8
    out = [[None] * reps for _ in range(n_clients)]
    start = threading.Barrier(n_clients + 1)
    with SearchEngine(api.FlatIndex(device="cuda").build(x), max_batch=8,
                      max_wait_ms=2.0, cache_size=0) as eng:
        def client(i):
            start.wait()
            for j in range(reps):
                out[i][j] = eng.search_one(x[i], 10)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        start.wait()
        eng.hot_swap(lambda: api.FlatIndex(device="cuda").build(bigger))
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        st = eng.stats()
    assert st["mutation"]["swaps"] == 1
    assert st["requests"] == n_clients * reps
    for i in range(n_clients):
        for r in out[i]:
            assert r is not None and r.indices[0, 0] == i
            assert r.scores[0, 0] == 0.0
