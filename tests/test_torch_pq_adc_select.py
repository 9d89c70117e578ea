"""The selection of the card's ``pq_adc`` kernel, modelled on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/pq_adc.cu``) runs
``l2_topk``'s selection (``csrc/topk_select.cuh``) over ADC scores: per
(query, chunk of rows) a running threshold and a survivor list that a
radix select cuts back to k when it passes its cut point after a tile;
pilots over every 16th (and 256th) row seed those thresholds; a merge pass
selects k from the chunks' lists and sorts them. ``ref.pq_adc_select_ref``
runs that algorithm in plain PyTorch, and these tests run it at the
wrapper's own plan (``kernel.plan``, ``kernel.schedule``,
``kernel.plan_chunks`` at the H100's 132 SMs and 227 KB of shared memory a
block), and with lists and tiles shrunk so that cuts happen often.

Tolerances: the model selects from the plain version's own scores, so ids
and scores must equal ``pq_adc_ref``'s bit for bit, ties to the lower row
included. Against the reference's Pallas op in interpret mode (XLA's sum
order) ids must be equal and scores within ``rtol=1e-5, atol=1e-4``, and
bit-equal on integer inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import pq_adc as jax_pq_adc  # noqa: E402
from repro_torch.kernels.pq_adc.kernel import (  # noqa: E402
    MAX_K, PILOT_STEP, STATIC_SMEM, list_cut, plan, plan_chunks, schedule,
    scan_smem)
from repro_torch.kernels.pq_adc.ref import (  # noqa: E402
    pq_adc_ref, pq_adc_select_ref)

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4
H100_SMS, H100_SMEM = 132, 232_448


def _model(q, cb, codes, k, shrunk=False):
    """The wrapper's plan and schedule through the model (one scan block
    an SM); ``shrunk``: lists cut at k + 32 after tiles of 64 rows."""
    m, ksub, _ = cb.shape
    bq, tile, _, cut, _ = plan(k, m, ksub, H100_SMEM - STATIC_SMEM)
    seed = None
    for n_scan, step in schedule(codes.shape[0], k):
        chunk, _, _ = plan_chunks(q.shape[0], n_scan, tile, bq, H100_SMS)
        t, c = (64, k + 32) if shrunk else (tile, cut)
        seed = pq_adc_select_ref(q, cb, codes, k, chunk, t, c,
                                 row_step=step, seed=seed)
    return seed


def _inputs(seed, q_n, n, m, ksub, dsub, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        qs = rng.integers(-3, 4, (q_n, m * dsub)).astype(np.float32)
        cb = rng.integers(-3, 4, (m, ksub, dsub)).astype(np.float32)
    else:
        qs = rng.normal(size=(q_n, m * dsub)).astype(np.float32)
        cb = rng.normal(size=(m, ksub, dsub)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    return [torch.from_numpy(a) for a in (qs, cb, codes)]


def _assert_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


# (Q, N, m, ksub, dsub, k): one query; PQ8x8 with several chunks; m = 4
# and m = 3 (the byte copies); k near N; the pilots' samples long enough to
# seed (N >= 16 k: one pilot at k = 320 over 12k rows, two at k = 10)
SELECT_CASES = [(1, 3001, 8, 256, 2, 1), (5, 2500, 8, 256, 2, 10),
                (3, 4000, 4, 16, 2, 40), (2, 1500, 3, 5, 3, 1400),
                (2, 12_001, 8, 64, 1, 320), (3, 70_001, 8, 16, 1, 10)]
SELECT_PARAMS = [(c, s) for c in SELECT_CASES for s in (False, True)]


@pytest.mark.parametrize(
    "case,shrunk", SELECT_PARAMS,
    ids=[f"q{c[0]}-n{c[1]}-m{c[2]}-k{c[5]}-{'shrunk' if s else 'plan'}"
         for c, s in SELECT_PARAMS])
def test_select_model_equals_plain_scan(case, shrunk):
    q_n, n, m, ksub, dsub, k = case
    q, cb, codes = _inputs(n + k, q_n, n, m, ksub, dsub)
    _assert_equal(_model(q, cb, codes, k, shrunk), pq_adc_ref(q, cb, codes,
                                                               k))


@pytest.mark.parametrize("kind", ["one_code", "ints"])
def test_select_model_ties_bit_equal(kind):
    """Every row the same code (every score tied: the lower row wins, the
    pilot's seed passes about 16k rows, a list is cut again and again) and
    integer LUTs (dense ties)."""
    q, cb, codes = _inputs(7, 3, 40_001, 8, 16, 2, integer=kind == "ints")
    if kind == "one_code":
        codes[:] = codes[0]
    for k in (1, 40, 1200):
        for shrunk in (False, True):
            _assert_equal(_model(q, cb, codes, k, shrunk),
                          pq_adc_ref(q, cb, codes, k))


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_select_model_matches_pallas(k, integer):
    q, cb, codes = _inputs(k, 9, 1000, 8, 32, 2, integer)
    want = jax_pq_adc(jnp.asarray(q.numpy()), jnp.asarray(cb.numpy()),
                      jnp.asarray(codes.numpy().astype(np.int32)), k,
                      impl="pallas", bq=8, bn=128, interpret=True)
    v, i = _model(q, cb, codes, k, shrunk=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))
    if integer:
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[0]))
    else:
        np.testing.assert_allclose(v.numpy(), np.asarray(want[0]),
                                   rtol=RTOL, atol=ATOL)


def test_plan_fills_whole_waves_and_fits_the_card():
    """At the main path's shape (Q = 256, N = 1,000,003, PQ8x8, k = 320)
    the plan takes 16-query tiles and 2048-row code tiles in one block an
    SM, and the main pass's items fill whole waves of 132 blocks; the
    pilots seed it (two at k = 320 and 2048, one at k = 4032); every k up to
    MAX_K fits at PQ8x8, and a wide LUT falls back to narrower query
    tiles."""
    bq, tile, cap, cut, smem = plan(320, 8, 256, H100_SMEM - STATIC_SMEM)
    assert (bq, tile, cut, cap) == (16, 2048, 672, 2720)
    assert smem == scan_smem(16, 2048, 8, 256) <= H100_SMEM
    chunk, chunks, grid = plan_chunks(256, 1_000_003, tile, bq, H100_SMS)
    assert grid == H100_SMS and (16 * chunks) % H100_SMS == 0
    assert chunk % tile == 0 and (chunks - 1) * chunk < 1_000_003 <= \
        chunks * chunk
    assert schedule(1_000_003, 320) == [(3907, 256), (62501, 16),
                                        (1_000_003, 1)]
    assert schedule(1_000_003, 2048) == [(3907, 256), (62501, PILOT_STEP),
                                         (1_000_003, 1)]
    assert schedule(1_000_003, 4032) == [(62501, PILOT_STEP),
                                         (1_000_003, 1)]
    for k in (1, 2048, MAX_K):
        assert plan(k, 8, 256, H100_SMEM - STATIC_SMEM)[0] == 16
    assert plan(40, 16, 256, H100_SMEM - STATIC_SMEM)[0] == 4
    assert plan(10, 64, 256, H100_SMEM - STATIC_SMEM)[:2] == (1, 1024)
    assert list_cut(1) == 128 and list_cut(320) == 672
    with pytest.raises(ValueError, match="shared memory"):
        plan(40, 64, 4096, H100_SMEM - STATIC_SMEM)
