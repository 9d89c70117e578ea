"""Parity of the port's kernel ops (``repro_torch.kernels``) with the
reference's Pallas ops.

On the CPU the port's ops run their plain PyTorch versions; the reference's
run their Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them (small ``bq/bn/br/bk``, so every case exercises the padding).
Inputs are made with numpy from a seed and handed to both.

Tolerances: ids must be equal; scores within ``rtol=1e-5, atol=1e-4``
(float32 sums taken in another order by XLA and by PyTorch). On an
integer-valued corpus every product and sum is exact in float32, so scores
must be bit-equal there, and ties must go to the lower id. ``embedding_bag``
adds each bag's rows in the Pallas kernel's slot order, so the two are
equal; against the reference's ``ref.py`` (XLA's own sum order) within
``rtol=1e-6``. ``flash_decode`` is held to the reference's own sweep bar,
``rtol=2e-4, atol=2e-5`` (float32 softmax sums in another order).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import embedding_bag as jax_embedding_bag  # noqa: E402
from repro.kernels import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels import graph_beam_q as jax_graph_beam_q  # noqa: E402
from repro.kernels import l2_topk as jax_l2_topk  # noqa: E402
from repro.kernels import pq_adc as jax_pq_adc  # noqa: E402
from repro.kernels import rae_encode as jax_rae_encode  # noqa: E402
from repro.kernels import topk_merge as jax_topk_merge  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref  # noqa: E402
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_decode_ref  # noqa: E402
from repro.kernels.graph_beam_q.ref import graph_beam_q_ref as jax_hop_q_ref  # noqa: E402
from repro.kernels.pq_adc.ref import pq_adc_ref as jax_pq_ref  # noqa: E402
from repro.kernels.topk_merge.ref import topk_merge_ref as jax_merge_ref  # noqa: E402
from repro_torch.kernels import (embedding_bag, embedding_bag_bwd,  # noqa: E402
                                 flash_decode, graph_beam_q, l2_topk,
                                 pq_adc, rae_encode, topk_merge)
from repro_torch.kernels.common import NEG_INF, PAD_ID  # noqa: E402
from repro_torch.kernels.l2_topk.ref import l2_topk_scan_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    float32 values to nearest-even in both frameworks)."""
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.copy()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# rae_encode
# ---------------------------------------------------------------------------
# (rows, n, m, br, bk): ragged rows, ragged contraction, n = 1 (the
# reference's parity cases) and the paper's widths at a few rows, in
# float32 and with bf16 inputs
ENCODE_CASES = [(77, 64, 16, 64, 64), (64, 129, 16, 64, 128),
                (32, 1, 8, 32, 128), (40, 768, 64, 32, 256)]
ENCODE_PARAMS = [(ENCODE_CASES[0], False, "f32"),
                 (ENCODE_CASES[0], True, "f32"),
                 (ENCODE_CASES[1], True, "f32"),
                 (ENCODE_CASES[2], True, "f32"),
                 (ENCODE_CASES[3], False, "f32"),
                 (ENCODE_CASES[0], True, "bf16"),
                 (ENCODE_CASES[1], False, "bf16")]


@pytest.mark.parametrize(
    "case,normalize,dtype", ENCODE_PARAMS,
    ids=[f"{c[0]}x{c[1]}x{c[2]}-{'norm' if nm else 'raw'}-{dt}"
         for c, nm, dt in ENCODE_PARAMS])
def test_rae_encode_matches_pallas(case, normalize, dtype):
    rows, n, m, br, bk = case
    xj, xt = _pair(_normal(rows, (rows, n)), dtype)
    wj, wt = _pair(_normal(n + 1, (n, m), 0.05), dtype)
    want = jax_rae_encode(xj, wj, normalize=normalize, impl="pallas", br=br,
                          bk=bk, interpret=True)
    got = rae_encode(xt, wt, normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == (rows, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_rae_encode_integer_inputs_bit_equal():
    # the shapes of ENCODE_CASES[0], so the reference's compile is reused
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (77, 64)).astype(np.float32)
    w = rng.integers(-2, 3, (64, 16)).astype(np.float32)
    want = jax_rae_encode(jnp.asarray(x), jnp.asarray(w), normalize=False,
                          impl="pallas", br=64, bk=64, interpret=True)
    got = rae_encode(torch.from_numpy(x), torch.from_numpy(w),
                     normalize=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rae_encode_default_normalizes_like_pallas_op():
    x, w = _normal(1, (8, 16)), _normal(2, (16, 4))
    z = rae_encode(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(np.linalg.norm(z, axis=1), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# l2_topk
# ---------------------------------------------------------------------------
# (q, n, d, k, bq, bn): ragged N, ragged Q, d = 1 (the reference's parity
# cases), k > N, k = 1, and the rerank-4 stage-1 k at the reduced width;
# float32 all, bf16 inputs on ragged N and k > N
TOPK_CASES = [(32, 333, 16, 5, 32, 128), (19, 256, 16, 5, 32, 128),
              (16, 100, 1, 3, 16, 32), (4, 6, 2, 10, 8, 8),
              (9, 200, 8, 1, 8, 64), (24, 300, 64, 40, 8, 128)]
TOPK_PARAMS = ([(c, "f32") for c in TOPK_CASES]
               + [(TOPK_CASES[0], "bf16"), (TOPK_CASES[3], "bf16")])


def _topk_both(q, n, d, k, bq, bn, dtype="f32", metric="euclidean",
               mask=None):
    qj, qt = _pair(_normal(q + n, (q, d)), dtype)
    dj, dt = _pair(_normal(n, (n, d)), dtype)
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    want = jax_l2_topk(qj, dj, k, metric=metric, db_mask=mj, impl="pallas",
                       bq=bq, bn=bn, interpret=True)
    got = l2_topk(qt, dt, k, metric=metric, db_mask=mt)
    return got, tuple(np.asarray(w) for w in want)


def _assert_topk_equal(got, want):
    v, i = got[0].numpy(), got[1].numpy()
    assert i.dtype == np.int32 and v.dtype == np.float32
    np.testing.assert_array_equal(i, want[1])
    np.testing.assert_allclose(v, want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "case,dtype", TOPK_PARAMS,
    ids=[f"q{c[0]}-n{c[1]}-d{c[2]}-k{c[3]}-{dt}" for c, dt in TOPK_PARAMS])
def test_l2_topk_matches_pallas(case, dtype):
    got, want = _topk_both(*case, dtype=dtype)
    _assert_topk_equal(got, want)


@pytest.mark.parametrize("metric,masked", [("cosine", False),
                                           ("cosine", True),
                                           ("euclidean", True)])
def test_l2_topk_metric_and_mask_match_pallas(metric, masked):
    n = 150
    mask = None
    if masked:
        mask = np.random.default_rng(7).random(n) > 0.4
    got, want = _topk_both(11, n, 16, 12, 8, 64, metric=metric, mask=mask)
    _assert_topk_equal(got, want)
    if masked:
        assert not np.isin(got[1].numpy(), np.flatnonzero(~mask)).any()


def test_l2_topk_mask_leaves_fewer_than_k_rows():
    """Only 3 rows survive a k = 12 scan: the tail is (NEG_INF, PAD_ID).
    (The shapes of the masked case above, so its compile is reused.)"""
    mask = np.zeros(150, bool)
    mask[[5, 17, 133]] = True
    got, want = _topk_both(11, 150, 16, 12, 8, 64, mask=mask)
    _assert_topk_equal(got, want)
    assert np.all(got[1].numpy()[:, 3:] == PAD_ID)
    assert np.all(got[0].numpy()[:, 3:] == np.float32(NEG_INF))


def test_l2_topk_integer_corpus_bit_equal_and_ties_to_lower_id():
    # the shapes of TOPK_CASES[0], so the reference's compile is reused
    rng = np.random.default_rng(5)
    q = rng.integers(-1, 2, (32, 16)).astype(np.float32)
    db = rng.integers(-1, 2, (333, 16)).astype(np.float32)
    want = jax_l2_topk(jnp.asarray(q), jnp.asarray(db), 5, impl="pallas",
                       bq=32, bn=128, interpret=True)
    v, i = l2_topk(torch.from_numpy(q), torch.from_numpy(db), 5)
    v, i = v.numpy(), i.numpy()
    np.testing.assert_array_equal(v, np.asarray(want[0]))
    np.testing.assert_array_equal(i, np.asarray(want[1]))
    exact = -((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(v, np.take_along_axis(exact, i, 1))
    ties = v[:, 1:] == v[:, :-1]
    assert ties.any()  # the corpus does have ties
    assert np.all(i[:, 1:][ties] > i[:, :-1][ties])


def test_l2_topk_scan_ref_orders_pads_before_penalised_rows():
    """The scan's pads (NEG_INF, -1) win ties against a row whose score is
    NEG_INF too, as in the reference kernel's running merge."""
    q = torch.zeros((1, 2))
    d = torch.zeros((3, 2))
    d_sq = torch.tensor([0.0, 1e30, 0.0])
    v, i = l2_topk_scan_ref(q, d, d_sq, 3)
    assert i.tolist() == [[0, 2, -1]]
    assert v[0, 2].item() == np.float32(NEG_INF)


def test_l2_topk_rejects_unknown_metric():
    with pytest.raises(ValueError):
        l2_topk(torch.zeros((1, 2)), torch.zeros((3, 2)), 1, metric="dot")


# ---------------------------------------------------------------------------
# topk_merge
# ---------------------------------------------------------------------------
# (q, c, k, bq): the reference's parity cases (ragged Q with a pool that is
# not lane-aligned, k wider than the pool, a one-candidate pool), then the
# sharded search's shape (k1 = 40 from 8 shards) and an odd pool
MERGE_CASES = [(19, 96, 8, 16), (4, 6, 10, 8), (5, 1, 3, 8),
               (9, 320, 40, 8), (7, 45, 45, 8)]
MERGE_PARAMS = ([(c, "f32") for c in MERGE_CASES]
                + [(c, "bf16") for c in MERGE_CASES[:3]])


def _merge_inputs(q_n, c, seed):
    """Integer values (dense ties), ids unique per row with about 15%
    pads, and one fully drained row: the reference's harness."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-4, 4, (q_n, c)).astype(np.float32)
    ids = np.stack([rng.permutation(4 * c)[:c].astype(np.int32)
                    for _ in range(q_n)])
    ids[rng.random((q_n, c)) < 0.15] = -1
    ids[0] = -1
    return vals, ids


def _assert_merge_bits(got, want):
    """Ids equal, values equal bit for bit (the sign of zero too)."""
    v, i = got[0].numpy(), got[1].numpy()
    assert v.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(i, np.asarray(want[1]))
    np.testing.assert_array_equal(v.view(np.int32),
                                  np.asarray(want[0], np.float32)
                                  .view(np.int32))


@pytest.mark.parametrize(
    "case,dtype", MERGE_PARAMS,
    ids=[f"q{c[0]}-c{c[1]}-k{c[2]}-{dt}" for c, dt in MERGE_PARAMS])
def test_topk_merge_matches_reference_and_pallas(case, dtype):
    q_n, c, k, bq = case
    vals, ids = _merge_inputs(q_n, c, q_n + c + k)
    vj, vt = _pair(vals, dtype)
    got = topk_merge(vt, torch.from_numpy(ids), k)
    _assert_merge_bits(got, jax_merge_ref(vj.astype(jnp.float32),
                                          jnp.asarray(ids), k))
    want = jax_topk_merge(vj, jnp.asarray(ids), k, impl="pallas", bq=bq,
                          interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    v, i = got[0].numpy(), got[1].numpy()
    kv = min(k, c)  # the k > c tail (and drained rows) is canonical padding
    assert np.all(v[:, kv:] == np.float32(NEG_INF)) and np.all(i[:, kv:] == -1)
    assert np.all(i[0] == PAD_ID) and np.all(v[0] == np.float32(NEG_INF))


def test_topk_merge_signed_zero_ties_break_to_the_lower_id():
    """-0.0 and +0.0 compare equal: the lower id wins and each slot keeps
    its own value. (Euclidean Flat scores are -0.0 at distance 0.) The
    Pallas kernel writes the sweep's max instead, so against it only the
    values' equality is checked, as ``==`` sees them."""
    vals = np.array([[-0.0, 0.0, 0.0, -0.0, -1.0, 1.0]], np.float32)
    ids = np.array([[9, 4, 7, 2, 0, 11]], np.int32)
    got = topk_merge(torch.from_numpy(vals), torch.from_numpy(ids), 6)
    assert got[1].tolist() == [[11, 2, 4, 7, 9, 0]]
    assert np.signbit(got[0].numpy()[0]).tolist() == [False, True, False,
                                                      False, True, True]
    _assert_merge_bits(got, jax_merge_ref(jnp.asarray(vals),
                                          jnp.asarray(ids), 6))
    want = jax_topk_merge(jnp.asarray(vals), jnp.asarray(ids), 6,
                          impl="pallas", bq=8, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_topk_merge_live_ids_at_neg_inf_keep_their_ids():
    """A live id whose value is NEG_INF beats a pad (same value, pad id
    ID_MAX) and comes out with its id, in the reference's ref and in its
    Pallas kernel alike."""
    vals = np.array([[NEG_INF, 3.0, 4.0, 5.0, NEG_INF],
                     [NEG_INF, NEG_INF, 1.0, 1.0, 2.0]], np.float32)
    ids = np.array([[6, -1, 8, 2, 1], [3, 4, -1, 0, -1]], np.int32)
    got = topk_merge(torch.from_numpy(vals), torch.from_numpy(ids), 5)
    assert got[1].tolist() == [[2, 8, 1, 6, -1], [0, 3, 4, -1, -1]]
    _assert_merge_bits(got, jax_merge_ref(jnp.asarray(vals),
                                          jnp.asarray(ids), 5))
    want = jax_topk_merge(jnp.asarray(vals), jnp.asarray(ids), 5,
                          impl="pallas", bq=8, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_topk_merge_live_ids_at_minus_inf_follow_the_reference_ref():
    """A live id at -inf ranks after the pads (NEG_INF > -inf) and still
    comes out with its id once k reaches it: the order of the reference's
    ``ref.py``, which the port follows. (The reference's Pallas kernel
    masks each taken entry to (NEG_INF, ID_MAX), which outranks -inf, so
    it emits pads there instead: ROADMAP.md queue C.)"""
    vals = np.array([[NEG_INF, 3.0, float("-inf"), 5.0, NEG_INF],
                     [float("-inf"), NEG_INF, 1.0, 1.0, 2.0]], np.float32)
    ids = np.array([[6, -1, 8, 2, 1], [3, 4, -1, 0, -1]], np.int32)
    got = topk_merge(torch.from_numpy(vals), torch.from_numpy(ids), 5)
    assert got[1].tolist() == [[2, 1, 6, -1, 8], [0, 4, -1, -1, 3]]
    assert np.isneginf(got[0].numpy()[[0, 1], [4, 4]]).all()
    _assert_merge_bits(got, jax_merge_ref(jnp.asarray(vals),
                                          jnp.asarray(ids), 5))


# ---------------------------------------------------------------------------
# pq_adc
# ---------------------------------------------------------------------------
# (q, n, m, ksub, dsub, k, bq, bn): the reference's parity cases (ragged N,
# k > N, dsub = 1) and its sweep, the Pallas kernel in interpret mode with
# small tiles
PQ_CASES = {"ragged_n": (17, 337, 4, 16, 4, 5, 32, 128),
            "k_gt_n": (4, 6, 2, 4, 2, 10, 8, 8),
            "d1": (8, 64, 1, 8, 1, 3, 8, 32),
            "sweep": (16, 200, 4, 16, 8, 5, 32, 128),
            "pq8x8": (8, 300, 8, 256, 2, 40, 8, 128)}


def _pq_inputs(q_n, n, m, ksub, dsub, integer):
    rng = np.random.default_rng(q_n + n)
    if integer:
        qs = rng.integers(-3, 4, (q_n, m * dsub)).astype(np.float32)
        cb = rng.integers(-3, 4, (m, ksub, dsub)).astype(np.float32)
    else:
        qs = rng.normal(size=(q_n, m * dsub)).astype(np.float32)
        cb = rng.normal(size=(m, ksub, dsub)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    return qs, cb, codes


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("name", list(PQ_CASES))
def test_pq_adc_matches_pallas_and_reference_ref(name, integer):
    q_n, n, m, ksub, dsub, k, bq, bn = PQ_CASES[name]
    qs, cb, codes = _pq_inputs(q_n, n, m, ksub, dsub, integer)
    v, i = pq_adc(*(torch.from_numpy(a) for a in (qs, cb, codes)), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert v.shape == i.shape == (q_n, k)
    k_eff = min(k, n)
    # k > N: the tail pads with (-inf, -1), as the reference's op
    assert np.isneginf(v.numpy()[:, k_eff:]).all()
    assert (i.numpy()[:, k_eff:] == -1).all()
    want = jax_pq_adc(jnp.asarray(qs), jnp.asarray(cb),
                      jnp.asarray(codes.astype(np.int32)), k,
                      impl="pallas", bq=bq, bn=bn, interpret=True)
    ref = jax_pq_ref(jnp.asarray(qs), jnp.asarray(cb), jnp.asarray(codes),
                     k_eff)
    for wv, wi in ((want[0][:, :k_eff], want[1][:, :k_eff]), ref):
        np.testing.assert_array_equal(i.numpy()[:, :k_eff], np.asarray(wi))
        if integer:
            np.testing.assert_array_equal(v.numpy()[:, :k_eff],
                                          np.asarray(wv))
        else:
            np.testing.assert_allclose(v.numpy()[:, :k_eff], np.asarray(wv),
                                       rtol=RTOL, atol=ATOL)


def test_pq_adc_ties_go_to_the_lower_row_and_chunks_agree(monkeypatch):
    """Duplicate code rows tie exactly: the lower row comes first, as in
    ``lax.top_k``; scanning the rows in chunks changes nothing."""
    import importlib

    qs, cb, codes = _pq_inputs(6, 150, 4, 8, 2, True)
    codes[100:] = codes[:50]
    t = [torch.from_numpy(a) for a in (qs, cb, codes)]
    v, i = pq_adc(*t, 60)
    vr, ir = jax_pq_ref(*(jnp.asarray(a) for a in (qs, cb, codes)), 60)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    vv, ii = v.numpy(), i.numpy()
    ties = vv[:, 1:] == vv[:, :-1]
    assert ties.any() and np.all(ii[:, 1:][ties] > ii[:, :-1][ties])
    ref_mod = importlib.import_module("repro_torch.kernels.pq_adc.ref")
    monkeypatch.setattr(ref_mod, "CHUNK_BYTES", 8 * 4 * 6 * 17)
    vc, ic = pq_adc(*t, 60)
    assert torch.equal(vc, v) and torch.equal(ic, i)


def test_pq_adc_rejects_a_query_width_off_the_codebooks():
    qs, cb, codes = _pq_inputs(2, 10, 2, 4, 3, False)
    with pytest.raises(ValueError, match="m\\*dsub"):
        pq_adc(torch.from_numpy(qs[:, :5]), torch.from_numpy(cb),
               torch.from_numpy(codes), 3)


# ---------------------------------------------------------------------------
# graph_beam_q
# ---------------------------------------------------------------------------
# (mode, q_n, n, c, ksub, w, ef): the reference's parity cases (ragged Q,
# W = 1, ef > W, d = 1, tiny ksub with m = 1); the interpret-mode grid is
# (Q, W), so the cases stay small
BEAM_Q_CASES = {"sq8_ragged_q": ("sq8", 7, 60, 16, 0, 9, 8),
                "sq8_w1": ("sq8", 5, 30, 8, 0, 1, 6),
                "sq8_ef_gt_w": ("sq8", 3, 20, 4, 0, 3, 15),
                "sq8_d1": ("sq8", 4, 25, 1, 0, 5, 4),
                "pq_ragged_q": ("pq", 7, 60, 8, 16, 9, 8),
                "pq_ef_gt_w": ("pq", 3, 20, 4, 256, 3, 15),
                "pq_m1_tiny_ksub": ("pq", 5, 9, 1, 7, 4, 6)}


def _beam_q_inputs(seed, mode, q_n, n, c, ksub, w, ef, integer):
    """Random hop inputs, as the reference's ``_beam_q_case`` draws them
    (integer-valued operands and biases when ``integer``)."""
    rng = np.random.default_rng(seed)
    hi = 256 if mode == "sq8" else ksub
    codes = rng.integers(0, hi, (n, c)).astype(np.uint8)
    dop = c if mode == "sq8" else c * ksub
    if integer:
        q_op = rng.integers(-3, 4, (q_n, dop)).astype(np.float32)
        q_bias = rng.integers(-3, 4, q_n).astype(np.float32)
        node_bias = rng.integers(0, 9, n).astype(np.float32)
    else:
        q_op = (0.1 * rng.standard_normal((q_n, dop))).astype(np.float32)
        q_bias = rng.standard_normal(q_n).astype(np.float32)
        node_bias = np.abs(rng.standard_normal(n)).astype(np.float32)
    ids = rng.integers(-1, n, (q_n, w)).astype(np.int32)
    bv = np.full((q_n, ef), NEG_INF, np.float32)
    bi = np.full((q_n, ef), -1, np.int32)
    for s in range(min(2, ef)):
        bv[:, s] = -0.25 * (s + 1) - (10_000 if integer else 0)
        bi[:, s] = s
    return q_op, q_bias, codes, node_bias, ids, bv, bi


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("name", list(BEAM_Q_CASES))
def test_graph_beam_q_matches_pallas_and_reference_ref(name, integer):
    mode, q_n, n, c, ksub, w, ef = BEAM_Q_CASES[name]
    a = _beam_q_inputs(q_n * 7 + n + c, mode, q_n, n, c, ksub, w, ef,
                       integer)
    kw = {"mode": mode, "ksub": ksub if mode == "pq" else 0}
    mask = np.random.default_rng(n).random(n) > 0.3
    for db_mask in (None, mask):
        v, i = graph_beam_q(*(torch.from_numpy(x) for x in a),
                            db_mask=None if db_mask is None
                            else torch.from_numpy(db_mask), **kw)
        assert v.dtype == torch.float32 and i.dtype == torch.int32
        want = [jax_hop_q_ref(*a, db_mask=db_mask, **kw)]
        if db_mask is None:
            want.append(jax_graph_beam_q(*(jnp.asarray(x) for x in a),
                                         impl="pallas", interpret=True,
                                         **kw))
        for wv, wi in want:
            np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
            if integer:
                np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
            else:
                np.testing.assert_allclose(v.numpy(), np.asarray(wv),
                                           rtol=RTOL, atol=ATOL)
        if db_mask is not None:
            live = i.numpy()[i.numpy() >= 2]   # beam entries 0, 1 stay
            assert db_mask[live].all()


def test_graph_beam_q_rejects_bad_mode_ksub_and_operand():
    a = [torch.from_numpy(x) for x in _beam_q_inputs(0, "sq8", 2, 10, 4, 0,
                                                     3, 4, False)]
    with pytest.raises(ValueError, match="mode"):
        graph_beam_q(*a, mode="fp4")
    with pytest.raises(ValueError, match="ksub"):
        graph_beam_q(*a, mode="pq", ksub=0)
    with pytest.raises(ValueError, match="m\\*ksub"):
        graph_beam_q(*a, mode="pq", ksub=3)
    with pytest.raises(ValueError, match="sq8 operand dim"):
        graph_beam_q(a[0][:, :3], *a[1:], mode="sq8")


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------
# (V, d, B, L): the reference's ragged cases (odd_shapes, d1) and a d
# that takes the kernel's 16-byte loads
BAG_CASES = {"odd_shapes": (13, 5, 7, 3), "d1": (10, 1, 4, 5),
             "d16": (64, 16, 9, 6)}


def _bag_inputs(case, dtype, seed=0):
    v, d, b, l = case
    rng = np.random.default_rng(v + b + seed)
    tj, tt = _pair(_normal(v + seed, (v, d)), dtype)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    lens = rng.integers(1, l + 1, (b,)).astype(np.int32)
    return tj, tt, ids, lens


# every case in float32; the reference's two parity cases in bf16 too
BAG_PARAMS = ([(n, "f32", "mean") for n in BAG_CASES]
              + [("odd_shapes", "bf16", "mean"), ("d1", "bf16", "mean"),
                 ("d16", "bf16", "sum")])


@pytest.mark.parametrize("name,dtype,mode", BAG_PARAMS,
                         ids=["-".join(p) for p in BAG_PARAMS])
def test_embedding_bag_matches_pallas_and_reference_ref(name, dtype, mode):
    tj, tt, ids, lens = _bag_inputs(BAG_CASES[name], dtype)
    got = embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(lens),
                        mode)
    assert got.dtype == torch.float32 and got.shape == (ids.shape[0],
                                                        tt.shape[1])
    pallas = jax_embedding_bag(tj, jnp.asarray(ids), jnp.asarray(lens),
                               mode=mode, impl="pallas", interpret=True)
    # the same rows added in the same slot order: equal
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    want = jax_bag_ref(tj, jnp.asarray(ids), jnp.asarray(lens), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_embedding_bag_lengths_zero_and_past_the_bag():
    """lengths <= 0 give zeros; lengths > L sum all L slots and divide by
    the length, as the Pallas kernel does."""
    tj, tt, ids, _ = _bag_inputs(BAG_CASES["d16"], "f32")
    lens = np.array([0, -2, 6, 9, 40, 1, 3, 0, 7], np.int32)
    for mode in ("mean", "sum"):
        got = embedding_bag(tt, torch.from_numpy(ids),
                            torch.from_numpy(lens), mode).numpy()
        want = jax_embedding_bag(tj, jnp.asarray(ids), jnp.asarray(lens),
                                 mode=mode, impl="pallas", interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert np.all(got[[0, 1, 7]] == 0.0)
    full = embedding_bag(tt, torch.from_numpy(ids),
                         torch.from_numpy(np.full(9, 6, np.int32)), "sum")
    mean = embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(lens),
                         "mean")
    np.testing.assert_allclose(mean[4].numpy(), full[4].numpy() / 40,
                               rtol=1e-6)


def test_embedding_bag_clips_out_of_range_ids_c6():
    """ROADMAP C6: the port clips ids to [0, V-1], as the reference's op and
    model path do; the reference's ref.py reads jnp.take's fill instead,
    and an id >= V turns the bag to NaN even in a dead slot."""
    v, d = 4, 3
    table = _normal(0, (v, d))
    ids = np.array([[1, 7, 9], [-1, 2, 9], [5, 0, 0]], np.int32)
    lens = np.array([1, 2, 3], np.int32)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        torch.from_numpy(lens), "sum").numpy()
    np.testing.assert_array_equal(got[0], table[1])               # pads dead
    np.testing.assert_array_equal(got[1], table[0] + table[2])    # -1 -> 0
    np.testing.assert_array_equal(got[2], (table[3] + table[0]) + table[0])
    pallas = jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                               jnp.asarray(lens), mode="sum", impl="pallas",
                               interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    ref = np.asarray(jax_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(lens), "sum"))
    assert np.isnan(ref[0]).all() and np.isnan(ref[2]).all()


def test_embedding_bag_dead_slots_are_not_read():
    """A row that is not finite, seen only from a dead slot, leaves the bag
    finite here; the Pallas kernel adds it times zero and gets NaN (the one
    difference the port's docstring names)."""
    table = _normal(1, (6, 4))
    table[5] = np.nan
    ids = np.array([[0, 1, 5], [2, 5, 5]], np.int32)
    lens = np.array([2, 1], np.int32)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        torch.from_numpy(lens), "mean").numpy()
    np.testing.assert_array_equal(got[0], (table[0] + table[1]) / 2)
    np.testing.assert_array_equal(got[1], table[2])
    pallas = np.asarray(jax_embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(lens),
        mode="mean", impl="pallas", interpret=True))
    assert np.isnan(pallas).all()


def test_embedding_bag_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(torch.zeros(3, 2), torch.zeros(1, 2, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32), "max")
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_bwd(torch.zeros(1, 2),
                          torch.zeros(1, 2, dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), "max", 3)


# the backward (no Pallas counterpart: the reference differentiates its
# ref.py through XLA): the table's gradient, rows summed in (b, l) order
@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("name", sorted(BAG_CASES))
def test_embedding_bag_bwd_matches_jax_grad_of_reference_ref(name, mode):
    tj, tt, ids, lens = _bag_inputs(BAG_CASES[name], "f32")
    lens[0] = 0                                   # an empty bag
    grad = _normal(7, (ids.shape[0], tt.shape[1]))

    def f(t):
        return jnp.sum(jax_bag_ref(t, jnp.asarray(ids), jnp.asarray(lens),
                                   mode) * grad)

    want = np.asarray(jax.grad(f)(tj))
    got = embedding_bag_bwd(torch.from_numpy(grad), torch.from_numpy(ids),
                            torch.from_numpy(lens), mode, tt.shape[0])
    assert got.dtype == torch.float32 and got.shape == tt.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_autograd_backward_is_the_bwd_op(dtype):
    """The bag's ``autograd.Function``: its forward is the op's output bit
    for bit, its gradient ``embedding_bag_bwd``'s, cast to the table's
    dtype."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_autograd

    _, tt, ids, lens = _bag_inputs(BAG_CASES["d16"], dtype)
    grad = torch.from_numpy(_normal(8, (ids.shape[0], tt.shape[1])))
    table = tt.clone().requires_grad_(True)
    ids_t, lens_t = torch.from_numpy(ids), torch.from_numpy(lens)
    out = embedding_bag_autograd(table, ids_t, lens_t, "mean")
    assert torch.equal(out.detach(), embedding_bag(tt, ids_t, lens_t,
                                                   "mean"))
    out.backward(grad)
    want = embedding_bag_bwd(grad, ids_t, lens_t, "mean", tt.shape[0])
    assert table.grad.dtype == tt.dtype
    assert torch.equal(table.grad, want.to(tt.dtype))


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------
DEC_RTOL, DEC_ATOL = 2e-4, 2e-5
# (b, kh, g, dh, s, cur, bs): the reference's sweep
# (tests/test_kernels.py:117; sweep1 has cur_len = S) and its ragged cases
# (ragged_s, cur1, dh1)
DECODE_CASES = {
    "sweep0": (2, 2, 4, 16, 64, 37, 32), "sweep1": (4, 4, 1, 32, 128, 128, 32),
    "sweep2": (1, 1, 8, 64, 256, 1, 32), "sweep3": (3, 8, 2, 16, 96, 50, 32),
    "ragged_s": (2, 2, 2, 8, 50, 37, 32), "cur1": (1, 1, 4, 8, 64, 1, 32),
    "dh1": (2, 1, 2, 1, 33, 20, 16),
}


def _decode_inputs(case, dtype):
    b, kh, g, dh, s, _, _ = case
    qj, qt = _pair(_normal(b, (b, kh, g, dh)), dtype)
    kj, kt = _pair(_normal(b + 1, (b, s, kh, dh)), dtype)
    vj, vt = _pair(_normal(b + 2, (b, s, kh, dh)), dtype)
    return (qj, kj, vj), (qt, kt, vt)


# every case in float32; the reference's ragged parity cases in bf16 too
DECODE_PARAMS = ([(n, "f32") for n in DECODE_CASES]
                 + [(n, "bf16") for n in ("ragged_s", "cur1", "dh1")])


@pytest.mark.parametrize("name,dtype", DECODE_PARAMS,
                         ids=["-".join(p) for p in DECODE_PARAMS])
def test_flash_decode_matches_pallas_and_reference_ref(name, dtype):
    case = DECODE_CASES[name]
    cur, bs = case[5], case[6]
    (qj, kj, vj), (qt, kt, vt) = _decode_inputs(case, dtype)
    got = flash_decode(qt, kt, vt, cur)
    assert got.dtype == torch.float32 and got.shape == qt.shape
    pallas = jax_flash_decode(qj, kj, vj, cur, impl="pallas", bs=bs,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=DEC_RTOL, atol=DEC_ATOL)
    want = jax_decode_ref(qj, kj, vj, cur)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DEC_RTOL,
                               atol=DEC_ATOL)
    # a device-side length gives the same answer as a host int
    same = flash_decode(qt, kt, vt, torch.tensor(cur, dtype=torch.int32))
    np.testing.assert_array_equal(same.numpy(), got.numpy())


def test_flash_decode_at_cur_len_zero_gives_zeros_c5():
    """ROADMAP C5: at cur_len = 0 the port gives zeros, as the Pallas
    kernel and the model's decode path do; the reference's ref.py takes a
    softmax over a row of NEG_INF and returns the mean of every value."""
    case = (1, 1, 2, 8, 32, 0, 16)
    (qj, kj, vj), (qt, kt, vt) = _decode_inputs(case, "f32")
    got = flash_decode(qt, kt, vt, 0).numpy()
    assert np.all(got == 0.0)
    pallas = np.asarray(jax_flash_decode(qj, kj, vj, 0, impl="pallas",
                                         bs=16, interpret=True))
    assert np.all(pallas == 0.0)
    ref = np.asarray(jax_decode_ref(qj, kj, vj, 0))
    mean_v = np.asarray(vj).mean(axis=1)                  # [b, kh, dh]
    np.testing.assert_allclose(ref, np.broadcast_to(mean_v[:, :, None],
                                                    ref.shape), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(ref).max() > 0.1


def test_flash_decode_cur_len_past_the_cache_attends_to_every_position():
    """cur_len > S attends to all S positions, as the reference's ref.py
    does. The reference's Pallas op pads S up to a multiple of its block
    with zero rows and its mask does not stop at S, so there the pad rows
    join the softmax (one more difference of its two versions, beside C5)."""
    case = (1, 2, 3, 8, 40, 77, 16)
    (qj, kj, vj), (qt, kt, vt) = _decode_inputs(case, "f32")
    got = flash_decode(qt, kt, vt, 77)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_decode_ref(
        qj, kj, vj, 77)), rtol=DEC_RTOL, atol=DEC_ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  flash_decode(qt, kt, vt, 40).numpy())
    pallas = np.asarray(jax_flash_decode(qj, kj, vj, 77, impl="pallas",
                                         bs=16, interpret=True))
    assert np.abs(pallas - got.numpy()).max() > 1e-2   # its 8 zero pad rows


def test_flash_decode_ignores_positions_past_cur_len():
    """Rows past cur_len (stale or garbage, NaN included) change nothing."""
    case = DECODE_CASES["ragged_s"]
    _, (qt, kt, vt) = _decode_inputs(case, "f32")
    cur = case[5]
    got = flash_decode(qt, kt, vt, cur)
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[:, cur:] = float("nan")
    vt2[:, cur:] = 1e6
    np.testing.assert_array_equal(flash_decode(qt, kt2, vt2, cur).numpy(),
                                  got.numpy())
