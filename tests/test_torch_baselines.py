"""Parity of the port's Table 1 baselines (``repro_torch.core.baselines``)
and their reducers (``repro_torch.api.reducer``) with the reference
package, on the CPU.

The fits are the reference's host numpy line for line, so from the same
inputs the fitted arrays are bit-equal; Isomap's min-plus squaring runs in
torch, one float32 add per pair and a min, so its geodesics are bit-equal
too. ``transform`` runs the affine maps through the ``rae_encode`` op's
plain version (a torch matmul where the reference uses numpy's): within
``1e-5 x max |ref|``. UMAP's out-of-sample map picks its k nearest by
``torch.topk`` where the reference uses ``argpartition``: the same set
off ties, summed in another order (same tolerance). Reducer directories
load across packages with equal fingerprints; the factory stacks answer
as the reference's (ids equal, scores within f32 tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from threadpoolctl import threadpool_limits  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.core import baselines as jax_bl  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import baselines, metrics  # noqa: E402
from repro_torch.search import ivf  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's BLAS on one thread, as torch's: the fits here are numpy
    SVDs and eigensolvers, and several test workers share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def data():
    x = jax_synthetic.embedding_corpus(600, 40, n_clusters=5, intrinsic=10,
                                       seed=1)
    return jax_synthetic.train_test_split(x)


#: (name, constructor kwargs) at test size; the defaults stay the
#: reference's (checked below)
FITS = [("pca", {}), ("rp", {"seed": 3}), ("mds", {"max_train": 400}),
        ("isomap", {"n_neighbors": 8, "max_train": 300}),
        ("umap", {"n_neighbors": 10, "n_epochs": 20, "max_train": 300})]
FIT_IDS = [n for n, _ in FITS]


def _fields(obj):
    import dataclasses

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def fitted(data):
    tr, _ = data
    out = {}
    for name, kw in FITS:
        want = jax_bl.make_baseline(name, 8, **kw).fit(tr)
        got = baselines.make_baseline(name, 8, **kw)
        got = (got.fit(tr, device="cpu") if name == "isomap"
               else got.fit(tr))
        out[name] = (got, want)
    return out


def test_dataclass_fields_and_defaults_are_the_reference_s():
    for name in ("pca", "rp", "mds", "isomap", "umap"):
        got = _fields(baselines.make_baseline(name, 4))
        want = _fields(jax_bl.make_baseline(name, 4))
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if v is not None} == \
            {k: v for k, v in want.items() if v is not None}


@pytest.mark.parametrize("name", FIT_IDS)
def test_fitted_state_is_bit_equal(name, fitted):
    got, want = fitted[name]
    for key, v in _fields(want).items():
        g = getattr(got, key)
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape, key
            np.testing.assert_array_equal(g, v, err_msg=key)
        else:
            assert g == v, key


@pytest.mark.parametrize("name", FIT_IDS)
def test_transform_within_tolerance(name, fitted, data):
    got, want = fitted[name]
    _, te = data
    z = got.transform(torch.from_numpy(te))
    ref = np.asarray(want.transform(te))
    assert isinstance(z, torch.Tensor) and z.dtype == torch.float32
    assert z.shape == ref.shape == (te.shape[0], 8)
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(z.numpy(), ref, rtol=0, atol=tol)
    # numpy input: the same answer, on the CPU
    np.testing.assert_array_equal(got.transform(te).numpy(), z.numpy())


@pytest.mark.parametrize("n,chunk", [(37, 256), (150, 7), (5, 2)])
def test_isomap_geodesics_bit_equal(n, chunk, monkeypatch):
    """The min-plus squaring against the reference's
    ``_minplus_square_chunked``, one round and all ceil(log2 n) rounds,
    on a kNN graph with unreachable pairs (two components)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    x[n // 2:] += 100.0                        # a second component
    g = baselines.Isomap(4, n_neighbors=3).knn_graph(x)
    one = baselines._minplus_square_chunked(torch.from_numpy(g), chunk)
    want = np.asarray(jax_bl._minplus_square_chunked(jnp.asarray(g), chunk))
    np.testing.assert_array_equal(one.numpy(), want)
    # the byte cap shrinks the chunk, not the answer
    monkeypatch.setattr(baselines, "MINPLUS_BYTES", 4 * n * n * 3)
    np.testing.assert_array_equal(
        baselines._minplus_square_chunked(torch.from_numpy(g)).numpy(), want)
    gd = jnp.asarray(g)
    for _ in range(int(np.ceil(np.log2(max(n, 2))))):
        gd = jax_bl._minplus_square_chunked(gd)
    np.testing.assert_array_equal(baselines.geodesics(g, "cpu"),
                                  np.asarray(gd))
    if n > 20:                                 # components apart
        assert np.isinf(baselines.geodesics(g, "cpu")).any()


def test_reducers_registered_and_on_their_device():
    assert api.list_reducers() == jax_api.list_reducers()
    for name in ("pca", "rp", "mds", "isomap", "umap"):
        r = api.make_reducer(name, 4, device="cpu")
        assert type(r).__name__ == type(jax_api.make_reducer(name, 4)
                                        ).__name__
        assert r.kind == name and r.out_dim == 4 and not r.fitted
        with pytest.raises(RuntimeError, match="before fit"):
            r.transform(np.zeros((1, 4), np.float32))


@pytest.mark.parametrize("name,kw", FITS, ids=FIT_IDS)
def test_reducer_directories_load_across_packages(name, kw, data, tmp_path):
    tr, te = data
    ref = jax_api.make_reducer(name, 8, **kw).fit(tr)
    port = api.make_reducer(name, 8, device="cpu", **kw).fit(tr)
    assert port.fingerprint() == ref.fingerprint()
    ref.save(str(tmp_path / "r"))
    back = api.load_reducer(str(tmp_path / "r"), device="cpu")
    assert type(back) is type(port) and back.fingerprint() == \
        ref.fingerprint()
    port.save(str(tmp_path / "p"))
    again = jax_api.load_reducer(str(tmp_path / "p"))
    assert again.fingerprint() == ref.fingerprint()
    z = back.transform(te)
    np.testing.assert_array_equal(z.numpy(), port.transform(te).numpy())
    np.testing.assert_allclose(
        z.numpy(), np.asarray(again.transform(te)), rtol=0,
        atol=1e-5 * max(1.0, float(np.abs(np.asarray(ref.transform(te)))
                                   .max())))


@pytest.fixture
def ref_draws(monkeypatch):
    """The port's IVF k-means seeds from the reference's draws."""
    def draw(n, n_clusters, seed):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                          (n_clusters,), replace=False))

    monkeypatch.setattr(ivf, "init_rows", draw)


@pytest.mark.parametrize("spec", ["PCA8,Flat", "ISOMAP8,IVF16,Rerank2",
                                  "RP8,Flat,Rerank4", "MDS8,Flat"])
def test_factory_stacks_answer_like_the_reference(spec, data, ref_draws):
    tr, te = data
    kw = {"max_train": 300} if spec[:3] in ("ISO", "MDS") else {}
    port = api.index_factory(spec, reducer_kw=kw, device="cpu").build(tr)
    want = jax_api.index_factory(spec, reducer_kw=kw).build(tr)
    assert type(port.reducer).__name__ == type(want.reducer).__name__
    assert port.reducer.fingerprint() == want.reducer.fingerprint()
    got, ref = port.search(te, 10), want.search(te, 10)
    np.testing.assert_array_equal(got.indices, np.asarray(ref.indices))
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-4)


def test_pca_beats_rp_on_anisotropic(data):
    """Table 1's ordering at test size, with the port's metric on the
    port's transforms."""
    tr, te = data
    p = baselines.PCA(8).fit(tr)
    r = baselines.GaussianRP(8).fit(tr)
    acc_p = metrics.preservation_accuracy(te, p.transform(te), k=5)
    acc_r = metrics.preservation_accuracy(te, r.transform(te), k=5)
    assert acc_p > acc_r
