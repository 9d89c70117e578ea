"""The arithmetic of the port's card kernels, checked on the CPU.

The CUDA kernels cannot run here, so their numerics are modelled in plain
PyTorch and held against the reference package:

- ``rae_encode`` multiplies on the tensor cores in 3xTF32: each operand is
  split as ``big = rna(x)``, ``small = rna(x - big)`` (``tf32_split``, the
  ``cvt.rna.tf32.f32`` of the kernel) and the product is ``big @ big + big
  @ small + small @ big`` in float32. Each product of two TF32 values is
  exact in float32, so three float32 matmuls of the parts model it. It is
  held to the bar the card holds the kernel to, ``1e-4 x max(1, max
  |want|)``, against the reference's Pallas op (interpret mode), its plain
  op and a float64 product; one TF32 product misses that bar.
- ``flash_decode`` splits the KV axis (``split_plan``) and merges the
  splits' partial softmaxes; ``flash_decode_split_ref`` does that in plain
  PyTorch and is held within ``1e-5 x max |want|`` of the reference's
  Pallas op (interpret mode) and its ``ref.py``, at the split the wrapper
  picks and at finer ones, dead splits and ``cur_len = 0`` (zeros, C5)
  included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels import rae_encode as jax_rae_encode  # noqa: E402
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_decode_ref  # noqa: E402
from repro_torch.kernels.flash_decode.kernel import (TARGET_BLOCKS,  # noqa: E402
                                                     TILE, split_plan)
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    flash_decode_ref, flash_decode_split_ref)
from repro_torch.kernels.rae_encode.ref import tf32_split  # noqa: E402
from test_torch_kernels import DECODE_CASES, ENCODE_CASES  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ENCODE_TOL = 1e-4   # |got - want| <= ENCODE_TOL * max(1, max |want|)
DECODE_REL = 1e-5   # |got - want| <= DECODE_REL * max |want|
SMS = 132           # the H100's SMs


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _normalize(z):
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-12)


def three_tf32(x, w, normalize=False):
    """The kernel's product: three TF32 products summed in float32."""
    xb, xs = tf32_split(torch.as_tensor(x))
    wb, ws = tf32_split(torch.as_tensor(w))
    z = xs @ wb + xb @ ws + xb @ wb
    return _normalize(z) if normalize else z


def one_tf32(x, w):
    xb, _ = tf32_split(torch.as_tensor(x))
    wb, _ = tf32_split(torch.as_tensor(w))
    return xb @ wb


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# rae_encode: the 3xTF32 split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_rebuilds_its_input(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    big, small = tf32_split(torch.from_numpy(x))
    for part in (big, small):   # both parts are TF32: 13 low bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    back = big.double() + small.double()
    err = (back - torch.from_numpy(x).double()).abs()
    assert bool((err <= 2.0 ** -21 * torch.from_numpy(x).double().abs()
                 ).all())
    # x - big is exact in float32: big + small is x to 2^-22 of it, and
    # big alone only to 2^-11
    assert float((big.double() - torch.from_numpy(x).double()).abs().max()
                 ) > 0


def test_tf32_split_rounds_to_nearest_ties_away():
    # 1 + 2^-11 lies halfway between two TF32 values: rna takes the larger
    # magnitude; 1 + 2^-12 rounds down; the sign does not change that
    one = np.float32(1.0)
    x = torch.tensor([one + np.float32(2.0 ** -11), one + np.float32(2.0 ** -12),
                      -(one + np.float32(2.0 ** -11))], dtype=torch.float32)
    big, small = tf32_split(x)
    assert big.tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    assert small.tolist() == [-(2.0 ** -11), 2.0 ** -12, 2.0 ** -11]


def test_three_tf32_integer_inputs_are_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (333, 200)).astype(np.float32)
    w = rng.integers(-2, 3, (200, 64)).astype(np.float32)
    xb, xs = tf32_split(torch.from_numpy(x))
    assert not bool(xs.any())
    np.testing.assert_array_equal(three_tf32(x, w).numpy(), x @ w)


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("case", ENCODE_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}" for c in ENCODE_CASES])
def test_three_tf32_matches_pallas(case, normalize):
    rows, n, m, br, bk = case
    x, w = _normal(rows, (rows, n)), _normal(n + 1, (n, m), 0.05)
    want = jax_rae_encode(jnp.asarray(x), jnp.asarray(w),
                          normalize=normalize, impl="pallas", br=br, bk=bk,
                          interpret=True)
    assert _rel(three_tf32(x, w, normalize), want) <= ENCODE_TOL


# the shapes phase 1 of chip_smoke.py holds the kernel at
PHASE1 = [(4096, 768, 64), (4096, 768, 384)]


@pytest.fixture(scope="module", params=PHASE1,
                ids=[f"{r}x{n}x{m}" for r, n, m in PHASE1])
def phase1(request):
    rows, n, m = request.param
    x = _normal(10 + m, (rows, n))
    w = _normal(20 + m, (n, m), n ** -0.5)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    return x, w, exact


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "norm"])
def test_three_tf32_at_phase1_shapes(phase1, normalize):
    x, w, exact = phase1
    got = three_tf32(x, w, normalize).numpy()
    if normalize:
        exact = exact / np.maximum(np.linalg.norm(exact, axis=1,
                                                  keepdims=True), 1e-12)
    want = jax_rae_encode(jnp.asarray(x), jnp.asarray(w),
                          normalize=normalize, impl="ref")
    # float32's own error from the exact product is about 5e-7; the split
    # adds about as much again, 200x under the bar
    assert _rel(got, exact) <= 5e-6
    assert _rel(got, want) <= ENCODE_TOL
    assert _rel(got, want) <= 5e-6


def test_one_tf32_product_misses_the_bar_at_phase1_shapes(phase1):
    """Why the kernel splits: a single TF32 product (both operands rounded
    to 10 mantissa bits) is off by about 3e-4 of the largest raw output."""
    x, w, exact = phase1
    assert _rel(one_tf32(x, w).numpy(), exact) > ENCODE_TOL


# ---------------------------------------------------------------------------
# flash_decode: the split and merge
# ---------------------------------------------------------------------------
def _decode_inputs(case):
    b, kh, g, dh, s, _, _ = case
    q = _normal(b, (b, kh, g, dh))
    k = _normal(b + 1, (b, s, kh, dh))
    v = _normal(b + 2, (b, s, kh, dh))
    return q, k, v


def _splits(b, kh, s):
    """The wrapper's split and every finer whole-tile split of the cache,
    down to single tiles."""
    split, nsplit = split_plan(b, kh, s, TILE)
    plans = {(split, nsplit)}
    for per in (1, 2, 3):
        plans.add((per * TILE, -(-s // (per * TILE))))
    return sorted(plans)


def _close_decode(got, want):
    got, want = np.asarray(got), np.asarray(want)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= DECODE_REL * top, (
        np.abs(got - want).max(), top)


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_split_merge_matches_pallas_and_reference_ref(name):
    case = DECODE_CASES[name]
    b, kh, g, dh, s, cur, bs = case
    q, k, v = _decode_inputs(case)
    pallas = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cur, impl="pallas",
        bs=bs, interpret=True))
    ref = np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), cur))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for split, nsplit in _splits(b, kh, s):
        got = flash_decode_split_ref(qt, kt, vt, cur, split, nsplit).numpy()
        _close_decode(got, pallas)
        _close_decode(got, ref)
        # a length on the device gives the same answer as a host int
        same = flash_decode_split_ref(qt, kt, vt, torch.tensor(
            cur, dtype=torch.int32), split, nsplit).numpy()
        np.testing.assert_array_equal(same, got)


def test_split_merge_dead_splits_and_zero_length():
    """Lengths that leave splits dead (one live position, one split and a
    tile), ``cur_len`` 0 (zeros, as the Pallas kernel gives: C5) and past S
    (every position, as the port's plain version gives)."""
    b, kh, g, dh, s = 2, 2, 3, 16, 300
    q, k, v = _decode_inputs((b, kh, g, dh, s, 0, 0))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for split, nsplit in _splits(b, kh, s):
        for cur in (1, 65, split + 1, s - 1, s):
            got = flash_decode_split_ref(qt, kt, vt, cur, split, nsplit)
            _close_decode(got.numpy(), flash_decode_ref(qt, kt, vt,
                                                        cur).numpy())
            _close_decode(got.numpy(), np.asarray(jax_decode_ref(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cur)))
        zero = flash_decode_split_ref(qt, kt, vt, 0, split, nsplit)
        assert bool((zero == 0).all())
        past = flash_decode_split_ref(qt, kt, vt, s + 40, split, nsplit)
        _close_decode(past.numpy(), flash_decode_ref(qt, kt, vt, s).numpy())
    pallas = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, impl="pallas",
        bs=32, interpret=True))
    assert np.all(pallas == 0.0)


def test_split_merge_ignores_positions_past_the_length():
    case = DECODE_CASES["ragged_s"]
    b, kh, g, dh, s, cur, _ = case
    q, k, v = map(torch.from_numpy, _decode_inputs(case))
    k2, v2 = k.clone(), v.clone()
    k2[:, cur:], v2[:, cur:] = float("nan"), 1e6
    for split, nsplit in _splits(b, kh, s):
        np.testing.assert_array_equal(
            flash_decode_split_ref(q, k2, v2, cur, split, nsplit).numpy(),
            flash_decode_split_ref(q, k, v, cur, split, nsplit).numpy())


# (B, kh, S) of the llama3.2-1b decode cells: long_500k, decode_32k cut to
# B=32, the decode after phase 8's 8 x 2048 prefill, and the uncut
# decode_32k
DECODE_CELLS = [(1, 8, 524_288), (32, 8, 32_768), (8, 8, 2056),
                (128, 8, 32_768)]


@pytest.mark.parametrize("b,kh,s", DECODE_CELLS,
                         ids=[f"B{b}-S{s}" for b, kh, s in DECODE_CELLS])
def test_split_plan_at_the_decode_cells(b, kh, s):
    split, nsplit = split_plan(b, kh, s, TILE)
    assert split % TILE == 0                 # whole tiles
    assert nsplit * split >= s               # covers S
    assert (nsplit - 1) * split < s          # no split wholly past S
    blocks = b * kh * nsplit
    if s // TILE >= 2 * SMS:                 # enough tiles to fill the card
        assert blocks >= 2 * SMS             # two blocks on each SM
    assert blocks <= TARGET_BLOCKS + b * kh  # and not many more
    # the split depends on S alone: the same plan for every live length,
    # which stays on the device
    assert split_plan(b, kh, s, TILE) == (split, nsplit)


def test_split_plan_long_500k_and_decode_32k_values():
    assert split_plan(1, 8, 524_288, TILE) == (15_936, 33)
    assert split_plan(32, 8, 32_768, TILE) == (16_384, 2)
