"""Parity of the port's theory (``repro_torch.core.spectral``,
``repro_torch.core.theory``) and ``metrics.preservation_accuracy`` with the
reference package, on the CPU.

The same numpy inputs go through both packages. Tolerances: the spectral
stats within ``rtol=1e-5`` (two SVD implementations in float32); the
bound checks' booleans, ``certified_fraction`` and the drift monitor's
counts and decisions equal; the monitor's band within ``1e-5``.
``preservation_accuracy`` is equal; the kNN ids behind it are compared
modulo distance ties (the reference's ``knn_indices`` masks the diagonal
with ``eye * inf``, ``ROADMAP.md`` C2; the port sets the diagonal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from threadpoolctl import threadpool_limits  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as jax_metrics  # noqa: E402
from repro.core import spectral as jax_spectral  # noqa: E402
from repro.core import theory as jax_theory  # noqa: E402
from repro_torch.core import metrics, spectral, theory  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's BLAS on one thread, as torch's: the fits here are numpy
    SVDs and eigensolvers, and several test workers share the cores."""
    with threadpool_limits(1):
        yield


def _rand_w(seed, m, n, scale):
    rng = np.random.default_rng(seed)
    return rng.normal(0, scale, (m, n)).astype(np.float32)


def _rand_x(seed, b, n):
    rng = np.random.default_rng(seed + 1)
    return rng.normal(0, 1, (b, n)).astype(np.float32)


CASES = [(0, 4, 12, 0.5), (7, 16, 40, 2.0), (11, 24, 25, 0.05),
         (3, 2, 41, 3.0)]


@pytest.mark.parametrize("seed,m,n,scale", CASES)
def test_analyze_matches_reference(seed, m, n, scale):
    w = _rand_w(seed, m, n, scale)
    got = spectral.analyze(torch.from_numpy(w))
    want = jax_spectral.analyze(jnp.asarray(w))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5)
    np.testing.assert_allclose(
        spectral.condition_number(torch.from_numpy(w.T)).numpy(),
        np.asarray(jax_spectral.condition_number(jnp.asarray(w))),
        rtol=1e-5)


@pytest.mark.parametrize("seed,m,n,scale", CASES)
def test_bound_checks_give_the_reference_booleans(seed, m, n, scale):
    """Rayleigh (Eq. 13), the upper bound for all x, both bounds on the
    row space, and the null-space counterexample (test_theory.py's
    cases)."""
    w = _rand_w(seed, m, n, scale)
    x = _rand_x(seed, 64, n)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    mtm = w.T @ w
    r = theory.rayleigh_quotient(torch.from_numpy(mtm), tx[:16]).numpy()
    np.testing.assert_allclose(
        r, np.asarray(jax_theory.rayleigh_quotient(jnp.asarray(mtm),
                                                   jnp.asarray(x[:16]))),
        rtol=1e-5, atol=1e-6 * float(np.abs(mtm).max()))
    ev = np.linalg.eigvalsh(mtm.astype(np.float64))
    assert (r >= ev[0] - 1e-3 * abs(ev[-1]) - 1e-5).all()
    assert (r <= ev[-1] * (1 + 1e-4) + 1e-5).all()
    assert bool(theory.norm_upper_bound_holds(tw, tx)) \
        == bool(jax_theory.norm_upper_bound_holds(jnp.asarray(w),
                                                  jnp.asarray(x))) is True
    assert bool(theory.norm_bounds_hold(tw, tx)) \
        == bool(jax_theory.norm_bounds_hold(jnp.asarray(w),
                                            jnp.asarray(x))) is True
    # a null-space vector breaks the naive lower bound (m < n)
    _, _, vt = np.linalg.svd(w, full_matrices=True)
    null = vt[m:m + 1].astype(np.float32)
    s = spectral.singular_values(tw)
    wx = torch.linalg.norm(torch.from_numpy(null) @ tw.T)
    assert float(wx) < float(s[-1] * torch.linalg.norm(
        torch.from_numpy(null))) + 1e-4
    # ... so the full-space lower bound check fails where the row-space
    # one holds, in both packages
    big = np.concatenate([x, null * 5.0])
    want = jax_theory.empirical_distortion(jnp.asarray(w), jnp.asarray(big))
    got = theory.empirical_distortion(tw, torch.from_numpy(big))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)
    assert float(got["ratio_min"]) < float(got["sigma_min"])


def test_certified_fraction_equals_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 32)).astype(np.float32)
    w_good = np.eye(8, 32, dtype=np.float32)
    w_bad = np.diag(np.array([4.0, 1, 1, 1, 1, 1, 1, 0.25],
                             np.float32)) @ w_good
    fr = {}
    for name, w in (("good", w_good), ("bad", w_bad)):
        for k in (1, 5, 17):
            got = float(theory.certified_fraction(torch.from_numpy(w),
                                                  torch.from_numpy(x), k))
            want = float(jax_theory.certified_fraction(
                jnp.asarray(w), jnp.asarray(x), k))
            assert got == want, (name, k)
            fr[name, k] = got
    assert fr["good", 5] >= fr["bad", 5] and fr["good", 5] > 0.5


def test_drift_tracker_matches_the_reference_on_a_seeded_stream():
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(8, 24)) * 0.3).astype(np.float32)
    kw = dict(tol=0.1, threshold=0.2, min_observed=40)
    got = theory.DriftTracker.from_weights(torch.from_numpy(w), **kw)
    want = jax_theory.DriftTracker.from_weights(jnp.asarray(w), **kw)
    assert got.sigma_min == pytest.approx(want.sigma_min, rel=1e-5)
    assert got.sigma_max == pytest.approx(want.sigma_max, rel=1e-5)
    # both monitors on the reference's band: the decisions are then the
    # reference's on every batch of the stream
    got.sigma_min, got.sigma_max = want.sigma_min, want.sigma_max
    _, _, vt = np.linalg.svd(w)
    for b in range(12):
        n = int(rng.integers(1, 20))
        xs = rng.normal(size=(n, 24)).astype(np.float32)
        if b % 3 == 0:
            xs = xs @ vt[:8].T @ vt[:8]          # in row(W): in the band
        if b == 4:
            xs[0] = 0.0                            # a zero row is skipped
        zs = xs @ w.T * (1.0 if b < 6 else 3.0)   # then off the band
        frac = got.observe(torch.from_numpy(xs), torch.from_numpy(zs))
        assert frac == want.observe(xs, zs)
        assert (got.observed, got.violations, got.should_retrain) == (
            want.observed, want.violations, want.should_retrain)
        assert got.violation_rate == want.violation_rate
    assert want.should_retrain and got.should_retrain
    got.reset()
    assert got.observed == 0 and not got.should_retrain


def test_drift_tracker_band_and_trigger():
    """The reference's own case (test_mutation.py), on the port."""
    w = 2.0 * np.eye(4, 8, dtype=np.float32)
    t = theory.DriftTracker.from_weights(torch.from_numpy(w), tol=0.1,
                                         threshold=0.2, min_observed=16)
    assert t.sigma_min == pytest.approx(2.0) == t.sigma_max
    xs = np.zeros((32, 8), np.float32)
    xs[:, :4] = np.random.default_rng(29).integers(-8, 8, (32, 4)) + 0.5
    assert t.observe(xs, 2.0 * xs[:, :4]) == 0.0
    assert not t.should_retrain
    assert t.observe(xs, 5.0 * xs[:, :4]) == 1.0
    assert t.observed == 64 and t.violation_rate == pytest.approx(0.5)
    assert t.should_retrain


def _knn_modulo_ties(got, want, d):
    """Row by row: the two id sets differ only by rows at a tied
    distance (the k-th distance of the row)."""
    for r in range(got.shape[0]):
        a, b = set(got[r].tolist()), set(want[r].tolist())
        if a == b:
            continue
        kth = np.sort(d[r])[got.shape[1] - 1]
        for j in a ^ b:
            assert d[r, j] == kth, (r, j)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_preservation_accuracy_equals_the_reference(metric, k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(240, 32)).astype(np.float32)
    w = rng.normal(size=(32, 8)).astype(np.float32)
    z = x @ w
    got = metrics.preservation_accuracy(x, z, k=k, metric=metric, chunk=64)
    want = jax_metrics.preservation_accuracy(x, z, k=k, metric=metric)
    assert got == pytest.approx(want, abs=1e-7)
    ids = metrics.knn_indices(torch.from_numpy(x), torch.from_numpy(x), k,
                              metric, exclude_self=True).numpy()
    ref = np.asarray(jax_metrics.knn_indices(jnp.asarray(x), jnp.asarray(x),
                                             k, metric, exclude_self=True))
    d = np.array(jax_metrics.pairwise_distances(jnp.asarray(x),
                                                  jnp.asarray(x), metric))
    np.fill_diagonal(d, np.inf)
    _knn_modulo_ties(ids, ref, d)


def test_preservation_accuracy_integer_rows_and_isometry():
    """Integer rows: dense distance ties, the set overlap is still the
    reference's. An isometry onto the data's subspace preserves every
    neighbour (test_theory.py's case)."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (150, 6)).astype(np.float32)
    z = x[:, :4].copy()
    got = metrics.preservation_accuracy(torch.from_numpy(x),
                                        torch.from_numpy(z), k=5,
                                        metric_reduced="euclidean")
    want = jax_metrics.preservation_accuracy(x, z, k=5)
    assert got == pytest.approx(want, abs=1e-7)
    basis, _ = np.linalg.qr(rng.normal(size=(32, 8)).astype(np.float32))
    y = rng.normal(size=(200, 8)).astype(np.float32) @ basis.T
    assert metrics.preservation_accuracy(y, y @ basis, k=5) \
        == pytest.approx(1.0)
