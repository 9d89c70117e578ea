"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernels are built at
first use) and skips without one. The file imports only torch, numpy and
``repro_torch``, so it runs on a machine without JAX:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: on integer-valued inputs every product and sum is exact in
float32, so kernel and plain version must agree bit for bit, ids and
scores; on float inputs ids must be equal and values within 1e-4 of the
largest magnitude (float32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from repro_torch import api  # noqa: E402
from repro_torch.kernels import l2_topk  # noqa: E402
from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda  # noqa: E402
from repro_torch.kernels.l2_topk.ref import (l2_topk_ref,  # noqa: E402
                                             l2_topk_scan_ref, prepare)
from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda  # noqa: E402
from repro_torch.kernels.rae_encode.ref import rae_encode_ref  # noqa: E402

# a string condition is evaluated when the test runs, not at import
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card and nvcc")
TOL = 1e-4


def _ints(seed, shape, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape)
                             * scale).astype(np.float32))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


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
