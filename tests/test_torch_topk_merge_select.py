"""The selection of the card's ``topk_merge`` kernel, modelled on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/topk_merge.cu``) merges a
row of C candidates in a block by a cut of their 64-bit pair keys to the
k-th (in a narrow block, 5-bit windows counted with warp ballots and the
last 32 candidates ranked; in a wide one, 8-bit digits counted in a shared
histogram), a keep pass that takes the keys above the cut and only as many
of those at it as are still needed (pads share one key), and the order of
the k survivors (ranks counted up to ``RANK_MAX_K``, a bitonic sort
above); 128 threads a row up to ``NARROW_MAX_C``, 512 above.
``ref.topk_merge_select_ref`` runs that algorithm with numpy at the
wrapper's own plan (``kernel.plan``), and these tests hold it against the
plain version (``ref.topk_merge_ref``) and the reference's ref and Pallas
op.

Tolerances: none. The merge moves values, it computes none, so ids and
value bits (the sign of zero included) must equal the plain version's and
the reference's ref. The reference's Pallas kernel writes the sweep's max
(a tie of -0.0 and +0.0 comes out as either) and emits pads where a live
-inf ranks (``ROADMAP.md`` queue C, C4), so against it ids must be equal
and values equal as ``==`` sees them, on inputs without -inf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import topk_merge as jax_topk_merge  # noqa: E402
from repro.kernels.topk_merge.ref import topk_merge_ref as jax_merge_ref  # noqa: E402
from repro_torch.kernels.common import NEG_INF, PAD_ID  # noqa: E402
from repro_torch.kernels.topk_merge.kernel import (  # noqa: E402
    MAX_C, NARROW_MAX_C, NARROW_THREADS, RANK_MAX_K, WIDE_THREADS, plan,
    smem_bytes, sort_width)
from repro_torch.kernels.topk_merge.ref import (  # noqa: E402
    block_barriers, byte_cut, digit_cut, pin_pads, topk_merge_ref,
    topk_merge_select_ref, unsigned_keys)

jax.config.update("jax_platform_name", "cpu")

H100_SMEM = 232_448


def _model(vals, ids, k):
    """The model at the plan the wrapper launches (the pool widened to k
    first, as ``ops.topk_merge`` does)."""
    return topk_merge_select_ref(torch.from_numpy(vals),
                                 torch.from_numpy(ids), k,
                                 plan(max(vals.shape[1], k), k))


def _inputs(seed, q_n, c, pads=0.25, zeros=0.2, neg_inf=0.05, minus_inf=0.0,
            drained_row=True, ints=True):
    """Candidates as the sharded merge sees them: ids unique per row with a
    share of pads (-1), integer values (dense ties) or normal ones, signed
    zeros, live ids at NEG_INF and at -inf, and the first row all pads."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(4 * c)[:c] for _ in range(q_n)])
    ids = ids.astype(np.int32)
    ids[rng.random((q_n, c)) < pads] = -1
    vals = (rng.integers(-3, 4, (q_n, c)) if ints
            else rng.normal(size=(q_n, c))).astype(np.float32)
    vals[rng.random((q_n, c)) < zeros] = -0.0
    vals[rng.random((q_n, c)) < neg_inf] = NEG_INF
    vals[rng.random((q_n, c)) < minus_inf] = -np.inf
    if drained_row:
        ids[0] = -1
    return vals, ids


def _assert_bits(got, want):
    """Ids equal, values equal bit for bit (the sign of zero too)."""
    v, i = np.asarray(got[0]), np.asarray(got[1])
    assert v.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(i, np.asarray(want[1]))
    np.testing.assert_array_equal(v.view(np.int32),
                                  np.asarray(want[0], np.float32)
                                  .view(np.int32))


# (name, Q, C, k, input options): the main path's shape; dense ties; more
# pads than C - k; k = C; C on both sides of the narrow blocks' limit and k
# = C at it; a pool narrower than k; k = 1; the widest row at
# KNOB_LADDER's top rung (8 shards of 2048)
SELECT_CASES = [
    ("main", 9, 320, 40, {"ints": False}),
    ("ties", 7, 320, 40, {"zeros": 0.0, "neg_inf": 0.0}),
    ("signed_zeros", 5, 96, 16, {"zeros": 0.6}),
    ("neg_inf_minus_inf", 6, 200, 150, {"neg_inf": 0.2, "minus_inf": 0.2}),
    ("pads_over_c_minus_k", 5, 320, 300, {"pads": 0.5}),
    ("k_eq_c", 4, 45, 45, {}),
    ("narrow_limit", 3, NARROW_MAX_C, 40, {}),
    ("narrow_limit_k_eq_c", 3, NARROW_MAX_C, NARROW_MAX_C, {}),
    ("wide_side", 3, NARROW_MAX_C + 1, 40, {}),
    ("wide_side_pads", 3, NARROW_MAX_C + 1, 1000, {"pads": 0.6}),
    ("narrow_pool", 4, 6, 10, {}),
    ("k1", 4, 100, 1, {"ints": False}),
    ("widest", 2, MAX_C, 2048, {"ints": False, "minus_inf": 0.01}),
]


@pytest.mark.parametrize("name,q_n,c,k,opts", SELECT_CASES,
                         ids=[case[0] for case in SELECT_CASES])
def test_select_model_equals_plain_merge(name, q_n, c, k, opts):
    vals, ids = _inputs(q_n + c + k, q_n, c, **opts)
    got_v, got_i, stats = _model(vals, ids, k)
    want = topk_merge_ref(torch.from_numpy(vals), torch.from_numpy(ids), k)
    _assert_bits((got_v.numpy(), got_i.numpy()),
                 (want[0].numpy(), want[1].numpy()))
    _assert_bits((got_v.numpy(), got_i.numpy()),
                 jax_merge_ref(jnp.asarray(vals), jnp.asarray(ids), k))
    # the drained row: every slot (NEG_INF, PAD_ID)
    assert (got_i[0] == PAD_ID).all()
    assert (got_v[0] == np.float32(NEG_INF)).all()
    # no cut pass when every pair is kept; a pass resolves 5 bits at least
    assert (stats["passes"] == 0).all() == (k >= c)
    assert int(stats["passes"].max()) <= 13
    assert (stats["block_barriers"] >= 2).all()


@pytest.mark.parametrize("name,q_n,c,k,opts",
                         [s for s in SELECT_CASES
                          if s[0] in ("main", "ties", "signed_zeros",
                                      "pads_over_c_minus_k", "k_eq_c",
                                      "narrow_pool")],
                         ids=lambda x: x if isinstance(x, str) else None)
def test_select_model_matches_pallas(name, q_n, c, k, opts):
    """Against the reference's Pallas op in interpret mode: ids equal,
    values equal as ``==`` sees them (its sweep writes the max of a -0.0 /
    +0.0 tie)."""
    vals, ids = _inputs(q_n + c + k, q_n, c, **opts)
    got_v, got_i, _ = _model(vals, ids, k)
    want = jax_topk_merge(jnp.asarray(vals), jnp.asarray(ids), k,
                          impl="pallas", bq=8, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want[0]))


def test_select_model_signed_zero_ties_keep_their_bits():
    """-0.0 and +0.0 tie, the lower id first, each keeping its own sign;
    the cut falls inside the tie, on the tie-break id's bits (the key's
    low word)."""
    vals = np.array([[-0.0, 0.0, 0.0, -0.0, -1.0, 1.0]], np.float32)
    ids = np.array([[9, 4, 7, 2, 0, 11]], np.int32)
    v, i, _ = _model(vals, ids, 3)
    assert i.tolist() == [[11, 2, 4]]
    assert np.signbit(v.numpy()[0]).tolist() == [False, True, False]
    keys = unsigned_keys(*pin_pads(torch.from_numpy(vals),
                                   torch.from_numpy(ids), 3))[0]
    for cut in (digit_cut, byte_cut):
        assert cut(keys, 3)[0] < 32


def test_select_model_live_neg_inf_and_minus_inf_against_pads():
    """A live NEG_INF beats a pad on the id alone; a live -inf ranks below
    every pad and still comes out once k reaches it."""
    vals = np.array([[NEG_INF, 3.0, -np.inf, 5.0, NEG_INF],
                     [-np.inf, NEG_INF, 1.0, 1.0, 2.0]], np.float32)
    ids = np.array([[6, -1, 8, 2, 1], [3, 4, -1, 0, -1]], np.int32)
    for k in (3, 4, 5):
        v, i, _ = _model(vals, ids, k)
        want = topk_merge_ref(torch.from_numpy(vals), torch.from_numpy(ids),
                              k)
        _assert_bits((v.numpy(), i.numpy()),
                     (want[0].numpy(), want[1].numpy()))
    assert i.tolist() == [[2, 1, 6, -1, 8], [0, 4, -1, -1, 3]]


@pytest.mark.parametrize("cut", [digit_cut, byte_cut])
@pytest.mark.parametrize("k", [8, 20, 32])
def test_cut_with_shared_pad_keys(k, cut):
    """More pads than C - k: the cut lands on the pads' one key, and only
    ``need`` of them are kept."""
    vals, ids = _inputs(k, 1, 40, pads=0.9, drained_row=False)
    v, tb = torch.from_numpy(vals), torch.from_numpy(ids)
    live = int((tb >= 0).sum())
    assert 40 - k < 40 - live        # more pads than C - k
    keys = unsigned_keys(*pin_pads(v, tb, k))[0]
    shift, top, need, _, _ = cut(keys, k)
    t = keys >> np.uint64(shift)
    assert int((t > np.uint64(top)).sum()) == k - need == live
    assert int((t == np.uint64(top)).sum()) == 40 - live > need
    assert shift == 0                # the cut is the pads' one key


@pytest.mark.parametrize("cut", [digit_cut, byte_cut])
@pytest.mark.parametrize("seed", range(6))
def test_cut_keeps_the_top_k_keys(seed, cut):
    """Random widths, k, float and tied integer values: the keys above the
    cut and ``need`` of those at it are the row's k largest keys."""
    rng = np.random.default_rng(seed)
    c = int(rng.integers(2, 700))
    k = int(rng.integers(1, c))
    vals, ids = _inputs(seed, 1, c, ints=bool(seed % 2), drained_row=False)
    keys = unsigned_keys(*pin_pads(torch.from_numpy(vals),
                                   torch.from_numpy(ids), k))[0]
    shift, top, need, passes, rounds = cut(keys, k)
    t = keys >> np.uint64(shift)
    at = t == np.uint64(top)
    assert int((t > np.uint64(top)).sum()) == k - need
    assert int(at.sum()) >= need
    kept = np.concatenate([keys[t > np.uint64(top)], keys[at][:need]])
    np.testing.assert_array_equal(np.sort(kept), np.sort(keys)[-k:])
    assert 1 <= rounds <= passes + 1


def test_plan_paths_and_shared_memory():
    """128 threads a row up to NARROW_MAX_C (the fewest keys a thread that
    cover the row), 512 above; every launch fits an H100 block's shared
    memory; the sort is a power of two >= k; a thread a survivor for the
    rank count."""
    assert plan(320, 40) == (NARROW_THREADS, 3, 64)
    assert plan(NARROW_MAX_C, NARROW_MAX_C) == (NARROW_THREADS, 8, 1024)
    assert plan(NARROW_MAX_C + 1, 40) == (WIDE_THREADS, 32, 64)
    assert plan(MAX_C, 2048)[2] == 2048
    assert [sort_width(k) for k in (1, 2, 3, 40, 64, 65)] == [2, 2, 4, 64,
                                                               64, 128]
    assert NARROW_THREADS >= RANK_MAX_K
    for c, k in ((1, 1), (128, 128), (NARROW_MAX_C, NARROW_MAX_C),
                 (NARROW_MAX_C + 1, NARROW_MAX_C + 1), (MAX_C, MAX_C)):
        assert smem_bytes(c, k) <= H100_SMEM
    with pytest.raises(ValueError):
        plan(MAX_C + 1, 40)
    with pytest.raises(ValueError):
        plan(40, 41)


def test_block_barriers_counted():
    """Barriers a row: one a round of the cut, one a narrow pass and three
    a wide one, two around the keep pass's stores; past RANK_MAX_K
    survivors the sort's, 15 of its 66 stages at 2048 slots by 512 threads
    (those that leave a warp or lead into one that does) and two more. The
    parent's bitonic sort of 512 slots took 45 at C = 320."""
    assert block_barriers(NARROW_THREADS, 40, 64, 0, 0) == 2
    assert block_barriers(NARROW_THREADS, 40, 64, 4, 1) == 7
    assert block_barriers(WIDE_THREADS, 2048, 2048, 0, 0) == 2 + 17
    assert block_barriers(WIDE_THREADS, 2048, 2048, 3, 1) == 12 + 17
