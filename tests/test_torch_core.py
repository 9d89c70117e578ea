"""Parity of the port's RAE core (``repro_torch.core``, ``optim``, ``data``)
with the reference package, on the CPU.

Inputs and initial weights are made with numpy (or by the reference and
passed as numpy), so both packages start from the same numbers. Float32
sums are taken in another order by XLA and by PyTorch, so losses and
weights agree within a float32 tolerance stated at each check; what is
exact in both (batch indices, synthetic data, integer inputs) must be
bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import RAEConfig as JaxRAEConfig  # noqa: E402
from repro.core import metrics as jax_metrics  # noqa: E402
from repro.core import rae as jax_rae  # noqa: E402
from repro.core import trainer as jax_trainer  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.optim import cosine_annealing as jax_cosine  # noqa: E402
from repro_torch.configs import RAEConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import metrics, rae, trainer  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.optim import cosine_annealing  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _cfg(**kw):
    base = dict(in_dim=32, out_dim=8, steps=200, batch_size=32, seed=0)
    base.update(kw)
    return RAEConfig(**base), JaxRAEConfig(**base)


@pytest.fixture(scope="module")
def corpus():
    return synthetic.embedding_corpus(600, 32, n_clusters=4, intrinsic=10,
                                      seed=2)


def _jax_init(jcfg, seed=0):
    return {k: np.asarray(v)
            for k, v in jax_rae.init(jcfg, jax.random.PRNGKey(seed)).items()}


# ---------------------------------------------------------------------------
# data, config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n=500, dim=48, n_clusters=5, intrinsic=12, seed=3),
    dict(n=300, dim=16, normalize=True, seed=1),
])
def test_embedding_corpus_bit_equal(kw):
    np.testing.assert_array_equal(synthetic.embedding_corpus(**kw),
                                  jax_synthetic.embedding_corpus(**kw))


@pytest.mark.parametrize("kw", [
    dict(n=500, dim=48, n_clusters=5, intrinsic=12, seed=3),
    dict(n=300, dim=16, normalize=True, seed=1),
    dict(n=3, dim=16, n_clusters=8, seed=0),      # clusters drawn empty
])
def test_embedding_corpus_with_holdout_keeps_the_corpus(kw):
    """The corpus is the reference's draw byte for byte; the held-out rows
    are other rows of the same mixture (each nearer the corpus' clusters
    than a draw of another seed's mixture is)."""
    x, held = synthetic.embedding_corpus_with_holdout(holdout=200, **kw)
    np.testing.assert_array_equal(x, jax_synthetic.embedding_corpus(**kw))
    sizes = np.random.default_rng(kw["seed"]).multinomial(
        kw["n"], np.ones(kw.get("n_clusters", 8)) / kw.get("n_clusters", 8))
    full = sizes.min() > 0
    assert held.dtype == np.float32 and np.isfinite(held).all()
    assert (held.shape[0] == 200) if full else (held.shape[0] <= 200)
    assert held.shape[1] == kw["dim"]
    assert not (held[:, None, :] == x[None, :, :]).all(-1).any()
    if full:
        other = synthetic.embedding_corpus(**dict(kw, seed=kw["seed"] + 7))

        def nearest(a):
            d = ((a[:, None, :] - x[None, :, :]) ** 2).sum(-1)
            return np.sqrt(d.min(1)).mean()

        assert nearest(held) < nearest(other[:200])


def test_paper_dataset_and_split_bit_equal():
    assert synthetic.PAPER_DATASETS == jax_synthetic.PAPER_DATASETS
    a = synthetic.paper_dataset("imdb_like", 400, seed=4)
    np.testing.assert_array_equal(
        a, jax_synthetic.paper_dataset("imdb_like", 400, seed=4))
    b, held = synthetic.paper_dataset_with_holdout("imdb_like", 400, 50,
                                                   seed=4)
    np.testing.assert_array_equal(a, b)
    assert held.shape == (50, 768)
    for x, y in zip(synthetic.train_test_split(a, seed=1),
                    jax_synthetic.train_test_split(a, seed=1)):
        np.testing.assert_array_equal(x, y)


def test_rae_config_fields_match_reference():
    import dataclasses

    cfg, jcfg = _cfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


# ---------------------------------------------------------------------------
# RAE model
# ---------------------------------------------------------------------------
def test_init_is_fan_in_and_seeded():
    cfg, _ = _cfg(in_dim=256, out_dim=64, use_bias=True)
    p = rae.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["w_e"].shape == (256, 64) and p["w_d"].shape == (64, 256)
    assert abs(float(p["w_e"].std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(p["w_d"].std()) - 64 ** -0.5) < 0.05 * 64 ** -0.5
    assert float(p["b_e"].abs().sum()) == 0.0
    q = rae.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("explicit", [False, True])
def test_loss_and_parts_match_reference(corpus, explicit):
    cfg, jcfg = _cfg(explicit_frobenius=explicit, use_bias=True)
    params = _jax_init(jcfg)
    params["b_e"] = np.linspace(-1, 1, 8, dtype=np.float32)
    x = corpus[:64]
    want_loss, want_aux = jax_rae.loss_fn(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg)
    got_loss, got_aux = rae.loss_fn(params_from_jax(params, "cpu"),
                                    torch.from_numpy(x), cfg)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for k in ("recon", "frobenius_sq"):
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]),
                                   rtol=1e-5)
    tp = params_from_jax(params, "cpu")
    np.testing.assert_allclose(
        rae.encode(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jax_rae.encode(params, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    assert rae.encoder_matrix(tp).shape == (8, 32)


def test_cosine_schedule_matches_reference():
    ours, ref = cosine_annealing(1e-3, 1e-5, 300), jax_cosine(1e-3, 1e-5,
                                                              300)
    warm_ours = cosine_annealing(1e-3, 1e-5, 300, warmup_steps=10)
    warm_ref = jax_cosine(1e-3, 1e-5, 300, warmup_steps=10)
    for step in (0, 1, 5, 10, 150, 299, 300, 400):
        np.testing.assert_allclose(float(ours(step)), float(ref(step)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(warm_ours(step)),
                                   float(warm_ref(step)), rtol=1e-6)


def test_adamw_update_matches_reference():
    """Three steps with wd > 0 on a 2-D weight and a bias: lr read before
    the increment, decay as p - lr * (u + wd * p), bias not decayed."""
    from repro.optim import AdamW as JaxAdamW
    from repro_torch.optim import AdamW

    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = JaxAdamW(lr=jax_cosine(1e-2, 1e-4, 10), weight_decay=0.1)
    topt = AdamW(lr=cosine_annealing(1e-2, 1e-4, 10), weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_jax(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        tp, ts, tm = topt.update(params_from_jax(g, "cpu"), ts, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def test_batch_sampler_bit_equal(corpus):
    ours = trainer._batch_sampler(corpus, 16, seed=5)
    ref = jax_trainer._batch_sampler(corpus, 16, seed=5)
    for step in (0, 1, 7, 199):
        np.testing.assert_array_equal(ours(step), ref(step))


class _InjectInit:
    """Checkpoint-manager stand-in: hands the reference's ``train`` a given
    init as its "latest checkpoint" and stores nothing."""

    def __init__(self, params, opt_state):
        self._state = {"params": params, "opt_state": opt_state, "step": 0}

    def restore_latest(self):
        return self._state

    def save(self, step, state):
        del step, state


def test_trainer_matches_reference_from_same_init(corpus):
    """200 steps from the reference's init: every loss record within
    rtol=1e-4 and the final W_e within atol=1e-4 (float32 sums in another
    order through 200 Adam steps)."""
    cfg, jcfg = _cfg(steps=200)
    init = _jax_init(jcfg, seed=1)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    mgr = _InjectInit(jparams, jax_trainer.make_optimizer(jcfg).init(jparams))
    want = jax_trainer.train(jcfg, corpus, log_every=20,
                             checkpoint_manager=mgr)
    got = trainer.train(cfg, corpus, log_every=20,
                        init_params=params_from_jax(init, "cpu"),
                        device="cpu")
    want_losses = [(h["step"], h["loss"]) for h in want.history
                   if "loss" in h]
    got_losses = [(h["step"], h["loss"]) for h in got.history]
    assert [s for s, _ in got_losses] == [s for s, _ in want_losses]
    np.testing.assert_allclose([v for _, v in got_losses],
                               [v for _, v in want_losses], rtol=1e-4)
    np.testing.assert_allclose(got.params["w_e"].numpy(),
                               np.asarray(want.params["w_e"]), atol=1e-4)
    assert got_losses[-1][1] < 0.5 * got_losses[0][1]


def test_fit_transform_encodes_eval_rows(corpus):
    cfg, _ = _cfg(steps=20)
    z, res = trainer.fit_transform(cfg, corpus[:500], corpus[500:],
                                   log_every=10, device="cpu")
    assert z.shape == (100, 8) and np.isfinite(z).all()
    assert res.steps_run == 20 and res.history[-1]["step"] == 19
    assert all("loss" in h for h in res.history)


def test_train_rejects_wrong_width(corpus):
    cfg, _ = _cfg(in_dim=31)
    with pytest.raises(ValueError, match="in_dim"):
        trainer.train(cfg, corpus, device="cpu")


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_indices_and_recall_match_reference(corpus, metric):
    q, db = corpus[:40], corpus[40:]
    want = np.asarray(jax_metrics.knn_indices(jnp.asarray(q),
                                              jnp.asarray(db), 10, metric))
    got = metrics.knn_indices(torch.from_numpy(q), torch.from_numpy(db), 10,
                              metric, chunk=16)
    np.testing.assert_array_equal(got.numpy(), want)
    shifted = np.roll(want, 1, axis=0)
    assert metrics.recall_at_k(torch.from_numpy(shifted), got) == \
        pytest.approx(jax_metrics.recall_at_k(jnp.asarray(shifted),
                                              jnp.asarray(want)))


def test_knn_indices_ties_go_to_lower_index():
    db = torch.tensor([[1.0], [-1.0], [1.0], [2.0]])
    got = metrics.knn_indices(torch.zeros((1, 1)), db, 3)
    assert got.tolist() == [[0, 1, 2]]


def test_knn_indices_exclude_self_drops_only_the_diagonal(corpus):
    """Self excluded, the k nearest are the k+1 nearest without the point
    itself. (The reference masks with ``eye * inf``, whose ``0 * inf``
    off the diagonal is NaN: ROADMAP.md queue C.)"""
    x = torch.from_numpy(corpus[:50])
    got = metrics.knn_indices(x, x, 5, exclude_self=True, chunk=16)
    full = metrics.knn_indices(x, x, 6)
    assert torch.equal(full[:, 0], torch.arange(50))
    assert torch.equal(got, full[:, 1:])
