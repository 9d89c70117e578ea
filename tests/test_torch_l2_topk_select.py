"""The selection of the card's ``l2_topk`` kernel, modelled on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/l2_topk.cu``) keeps, per
(query, chunk of rows), a running threshold and a survivor list that a
radix select cuts back to k when it fills; pilots over every 16th (and
256th) row seed those thresholds; a second pass selects k from the chunks'
lists and sorts them. ``ref.l2_topk_select_ref`` runs that algorithm in
plain PyTorch, and these tests run it at the wrapper's own schedule and plan
(``kernel.schedule``, ``kernel.plan``), with lists shrunk so that cuts
happen often, in both list modes (shared memory: a group that would
overflow cuts; device memory: a list past its cut point after a tile is
cut).

Tolerances: the model selects from the plain version's own scores, so ids
and scores must equal ``l2_topk_scan_ref``'s bit for bit, ties to the lower
id included. Against the reference's Pallas op in interpret mode (XLA's sum
order) ids must be equal and scores within ``rtol=1e-5, atol=1e-4``, and
bit-equal on integer corpora.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import l2_topk as jax_l2_topk  # noqa: E402
from repro_torch.kernels.l2_topk.kernel import (  # noqa: E402
    MAX_K, PILOT_STEP, QUERY_TILE, RING_SMEM, ROW_TILE, STATIC_SMEM,
    list_cap, schedule)
from repro_torch.kernels.l2_topk.ref import (  # noqa: E402
    GROUP, finish, l2_topk_scan_ref, l2_topk_select_ref, order_keys, prepare,
    radix_select)

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4
H100_SMS, H100_SMEM = 132, 232_448
#: a card whose lists never fit in shared memory: the device-memory mode
SMALL_SMEM = RING_SMEM + STATIC_SMEM + 8 * QUERY_TILE * 64


def _model(q, d, d_sq, k, smem=H100_SMEM, cut=None):
    """The wrapper's schedule through the model; ``cut`` shrinks every
    list (its cap in shared memory, its cut point in device memory)."""
    seed = None
    for _, step, (chunk, _, smem_lists, cap, at) in schedule(
            q.shape[0], d.shape[0], k, H100_SMS, smem):
        if cut is not None:
            cap, at = (cut, cut) if smem_lists else (cut + ROW_TILE, cut)
        seed = l2_topk_select_ref(q, d, d_sq, k, chunk, cap,
                                  None if smem_lists else at,
                                  row_step=step, seed=seed)
    return seed


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _ints(seed, shape, lo=-1, hi=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, shape).astype(np.float32))


def _assert_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


# (Q, N, d, k): one query; a ragged second query tile; k > N; the pilot's
# sample long enough to seed (N >= 32 k)
SELECT_CASES = [(1, 3001, 8, 1), (5, 2500, 8, 10), (3, 4000, 16, 40),
                (2, 1500, 4, 2048), (2, 70_001, 4, 2048), (66, 700, 4, 10)]


# every mode on every case, but lists shrunk only on the short corpora
SELECT_PARAMS = [(c, m) for c in SELECT_CASES
                 for m in ("shared", "device", "shrunk")
                 if m != "shrunk" or c[1] < 10_000]


@pytest.mark.parametrize(
    "case,mode", SELECT_PARAMS,
    ids=[f"q{c[0]}-n{c[1]}-k{c[3]}-{m}" for c, m in SELECT_PARAMS])
def test_select_model_equals_plain_scan(case, mode):
    nq, n, d, k = case
    q, db, d_sq = prepare(_normal(nq, (nq, d)), _normal(n, (n, d)),
                          "euclidean", None)
    smem = H100_SMEM if mode == "shared" else SMALL_SMEM
    cut = k + GROUP if mode == "shrunk" else None
    _assert_equal(_model(q, db, d_sq, k, smem=smem, cut=cut),
                  l2_topk_scan_ref(q, db, d_sq, k))


@pytest.mark.parametrize("k", [1, 10, 40, 2048])
def test_select_model_matches_pallas(k):
    nq, n, d = 9, 2100 if k == 2048 else 1000, 8
    q, db = _normal(1, (nq, d)).numpy(), _normal(2, (n, d)).numpy()
    want = jax_l2_topk(jnp.asarray(q), jnp.asarray(db), k, impl="pallas",
                       bq=8, bn=512, interpret=True)
    qt, dt, d_sq = prepare(torch.from_numpy(q), torch.from_numpy(db),
                           "euclidean", None)
    v, i = _model(qt, dt, d_sq, k, cut=k + GROUP)
    v, i = finish(v, i, qt, "euclidean", False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(v.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["shared", "device"])
@pytest.mark.parametrize("kind", ["zeros", "one_row", "ints"])
def test_select_model_ties_bit_equal(kind, mode):
    """Every score tied (zero vectors; one row repeated) and a {-1, 0, 1}
    corpus: the model holds the plain version bit for bit, the lower id
    first, and the Pallas op on the integer corpus."""
    nq, n, d, k = 4, 3000, 6, 40
    if kind == "zeros":
        q, db = torch.zeros(nq, d), torch.zeros(n, d)
    elif kind == "one_row":
        q, db = _normal(3, (nq, d)), _normal(4, (1, d)).repeat(n, 1)
    else:
        q, db = _ints(5, (nq, d)), _ints(6, (n, d))
    qt, dt, d_sq = prepare(q, db, "euclidean", None)
    smem = H100_SMEM if mode == "shared" else SMALL_SMEM
    got = _model(qt, dt, d_sq, k, smem=smem, cut=k + GROUP)
    _assert_equal(got, l2_topk_scan_ref(qt, dt, d_sq, k))
    if kind != "ints":
        assert torch.equal(got[1], torch.arange(k, dtype=torch.int32)
                           .expand(nq, k))
    else:
        want = jax_l2_topk(jnp.asarray(q.numpy()), jnp.asarray(db.numpy()),
                           k, impl="pallas", bq=8, bn=256, interpret=True)
        v, i = finish(*got, qt, "euclidean", False)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("k", [10, 2048])
def test_select_model_tombstones_and_k_past_n(k):
    """Tombstoned rows ride the penalty lane and lose to the pads; with
    k > the live rows the tail is (NEG_INF, PAD_ID)."""
    nq, n, d = 3, 2500, 8
    mask = torch.from_numpy(np.random.default_rng(7).random(n) > 0.3)
    q, db, d_sq = prepare(_normal(8, (nq, d)), _normal(9, (n, d)),
                          "euclidean", mask)
    got = _model(q, db, d_sq, k, cut=k + GROUP)
    _assert_equal(got, l2_topk_scan_ref(q, db, d_sq, k))
    v, i = finish(*got, q, "euclidean", True)
    assert not np.isin(i.numpy(), np.flatnonzero(~mask.numpy())).any()
    if k > int(mask.sum()):
        assert torch.all(i[:, int(mask.sum()):] == -1)


def test_radix_select_keeps_the_k_largest_keys():
    rng = np.random.default_rng(10)
    for n, k in [(2, 1), (300, 1), (300, 299), (4096, 2048), (513, 40)]:
        # scores in a narrow range (shared top bits), some tied, any ids
        vals = torch.from_numpy(rng.integers(0, 50, n).astype(np.float32)
                                * 0.5 - 30.0)
        ids = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int32))
        keys = order_keys(vals, ids)
        keep, kth = radix_select(keys, k)
        want = torch.sort(keys, descending=True).values
        assert int(keep.sum()) == k
        assert torch.equal(torch.sort(keys[keep], descending=True).values,
                           want[:k])
        assert kth == int(want[k - 1])


def test_order_keys_order_pairs_as_the_scan_does():
    vals = torch.tensor([1.0, -0.0, 0.0, -1e30, -1e30, 2.5, -3.0])
    ids = torch.tensor([7, 3, 2, -1, 5, 0, 1], dtype=torch.int32)
    keys = order_keys(vals, ids)
    # score descending, then id ascending; -0 is +0; a pad (NEG_INF, -1)
    # beats a real pair at NEG_INF
    assert torch.argsort(keys, descending=True).tolist() == [5, 0, 2, 1, 6,
                                                             3, 4]


@pytest.mark.parametrize("nq,n,k", [(1, 1_000_000, 40), (256, 1_000_000, 40),
                                    (256, 1_000_000, 2048), (257, 100_003, 64),
                                    (1000, 5000, 4032), (3, 10, 5)])
def test_plan_and_schedule(nq, n, k):
    passes = schedule(nq, n, k, H100_SMS, H100_SMEM)
    assert passes[-1][:2] == (n, 1)
    steps = [step for _, step, _ in passes]
    assert steps == sorted(steps, reverse=True) and len(steps) <= 3
    for rows, step, (chunk, chunks, smem_lists, cap, cut) in passes:
        assert rows == -(-n // step) and (step == 1 or rows >= 2 * k)
        q_tiles = -(-nq // QUERY_TILE)
        assert chunk % ROW_TILE == 0 and (chunks - 1) * chunk < rows <= \
            chunks * chunk
        assert q_tiles * chunks <= max(H100_SMS, q_tiles)
        assert cut == list_cap(k) >= k + GROUP and cut >= 128
        if smem_lists:
            assert cap == cut
            assert RING_SMEM + 8 * QUERY_TILE * cap + STATIC_SMEM <= H100_SMEM
        else:
            assert cap == cut + ROW_TILE
            assert RING_SMEM + 8 * cap + STATIC_SMEM <= H100_SMEM
    # pilots seed when the sample holds 2k rows
    assert (len(passes) > 1) == (-(-n // PILOT_STEP) >= 2 * k)
    assert list_cap(MAX_K) <= 2 * MAX_K + GROUP
