"""Parity of the port's training path with the reference package, on the
CPU: the ``embedding_bag`` backward and the row lookup's gradient, the
recsys and LM losses and their gradients, the LM train step (with and
without gradient accumulation), AdamW on the models' parameter trees, the
two train cells, the data pipeline, the paper's RAE config and the
training launcher.

The reference's weights are drawn with JAX and carried across with
``convert.py``; batches are numpy draws handed to both packages.

Tolerances:
- the backward's plain version against ``jax.grad`` of the reference's
  model-site bag and ``jnp.take``: equal to float32 rounding (``rtol
  1e-6``; the same values summed in another order);
- float32 losses and gradients: ``rtol 1e-4`` (about 1e-6 seen: float32
  sums in another order), the LM at ``compute_dtype="float32"``; the
  two-tower at float32 through the reference's own blocks (its model
  hard-codes bfloat16 towers);
- in bfloat16 (the models' own compute dtype): losses within ``1e-3`` of
  the reference's, each gradient leaf within ``0.05`` (LM) or ``0.1``
  (two-tower) of its largest magnitude. The towers and layers round to
  bfloat16 at other places in the two frameworks, and the port's bag sums
  in float32 where the reference sums bfloat16 rows (``models/common.py``):
  2.5% (LM) and 8% (the two-tower's user table, whose gradient passes
  through both) seen;
- gradient accumulation sums bfloat16 gradients, as the reference does:
  each leaf within ``2 ** -7`` of its largest magnitude (a bfloat16 step);
- AdamW from the same gradients and state: float32 to ``rtol 1e-6``;
  bfloat16 moments within one bfloat16 step (``rtol 2 ** -7``: the global
  norm sums in another order, and a few float32 moments a last bit apart
  round to bfloat16 the other way, 2 of 16,384 seen), and the params they
  move within ``lr * 2 ** -6`` of the reference's;
- three steps of a train cell from the same params and batches: losses
  within the bfloat16 bars above (the first AdamW steps move each weight
  by about ``lr * sign(g)``, so the params are held only through the
  losses).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import TransformerConfig as JaxTransformerConfig  # noqa: E402
from repro.configs.reduce import reduce_cell as jax_reduce_cell  # noqa: E402
from repro.configs.reduce import reduce_config as jax_reduce  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import registry as jax_reg  # noqa: E402
from repro.models.common import NULL_CTX  # noqa: E402
from repro.models.recsys import common as jax_rc  # noqa: E402
from repro.models.recsys import two_tower as jax_tt  # noqa: E402
from repro.models.transformer import model as jax_tm  # noqa: E402
from repro_torch.configs import get_arch, get_shapes  # noqa: E402
from repro_torch.configs.base import RAEConfig, TransformerConfig  # noqa: E402
from repro_torch.configs.reduce import reduce_cell, reduce_config  # noqa: E402
from repro_torch.convert import (recsys_params_from_jax,  # noqa: E402
                                 transformer_params_from_jax)
from repro_torch.data import recsys_batch  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher,  # noqa: E402
                                       StepIndexedSource, to_device)
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_bwd_ref, sorted_slots)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.recsys import common as rc  # noqa: E402
from repro_torch.models.recsys import two_tower as tt  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.pytree import flatten_with_path  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32_RTOL = 1e-4
BF16_LOSS = 1e-3
LM_BF16_GRAD = 0.05
TT_BF16_GRAD = 0.1
ACCUM_REL = 2.0 ** -7


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _jax_leaves(tree) -> dict:
    """The reference tree's leaves by the port's paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(e, "key", getattr(e, "idx",
                                              getattr(e, "name", None)))
                    for e in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


def _assert_leaves_close(got: dict, want: dict, rel: float):
    """Every leaf of ``got`` within ``rel`` x its largest magnitude."""
    assert got.keys() == want.keys()
    for k in got:
        g = np.asarray(got[k], np.float32)
        w = want[k]
        top = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * top, (k, rel)


def _grads(loss_fn, params, *args):
    """(loss, metrics, {path: grad}) of ``loss_fn(params, *args)``."""
    (loss, metrics), grads = common.value_and_grad(loss_fn, params, *args)
    return loss, metrics, {p: g.numpy() for p, g in flatten_with_path(grads)}


# ---------------------------------------------------------------------------
# the embedding_bag backward and the row lookup's gradient
# ---------------------------------------------------------------------------
BAG_CASES = {
    # (V, d, B, L, seed): ids in [-3, V + 3), lengths in [-1, L + 3)
    "ragged": (13, 6, 9, 5, 0),
    "wide": (40, 33, 17, 11, 1),
    "one_slot": (7, 4, 5, 1, 2),
}


def _bag_inputs(v, d, b, l, seed):
    rng = np.random.default_rng(seed)
    table = _normal(seed, (v, d))
    ids = rng.integers(-3, v + 3, (b, l)).astype(np.int32)
    ids[0, :] = 4 % v                      # one id repeated inside a bag
    lens = rng.integers(-1, l + 3, b).astype(np.int32)
    lens[1] = 0                            # an empty bag
    grad = _normal(seed + 1, (b, d))
    return table, ids, lens, grad


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", sorted(BAG_CASES))
def test_embedding_bag_bwd_matches_jax_grad(case, mode):
    """The table's gradient of the reference's model-site bag
    (``models/common.py:embedding_bag``, ids clipped) for the same output
    gradient: clipped ids, empty and over-long bags, an id repeated in a
    bag."""
    v, d, b, l, seed = BAG_CASES[case]
    table, ids, lens, grad = _bag_inputs(v, d, b, l, seed)

    def f(t):
        out = jax_common.embedding_bag(t, jnp.asarray(ids), jnp.asarray(lens),
                                       NULL_CTX, mode=mode,
                                       compute_dtype=jnp.float32)
        return jnp.sum(out * grad)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    got = embedding_bag_bwd_ref(torch.from_numpy(grad), torch.from_numpy(ids),
                                torch.from_numpy(lens), mode, v)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_lookup_gradient_matches_jax_take():
    v, d = 11, 5
    table = _normal(0, (v, d))
    ids = np.array([[0, 10, 11, -3], [5, 99, 2, 5]], np.int32)
    grad = _normal(1, ids.shape + (d,))

    def f(t):
        out = jax_common.sharded_embedding_lookup(
            t, jnp.asarray(ids), NULL_CTX, compute_dtype=jnp.float32)
        return jnp.sum(out * grad)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    out = common.sharded_embedding_lookup(t, torch.from_numpy(ids),
                                          torch.float32)
    (out * torch.from_numpy(grad)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["bag_mean", "bag_sum", "lookup"])
def test_embedding_functions_gradcheck_float64(which):
    v, d, b, l, seed = BAG_CASES["ragged"]
    table, ids, lens, _ = _bag_inputs(v, d, b, l, seed)
    t = torch.from_numpy(table).double().requires_grad_(True)
    ids_t, lens_t = torch.from_numpy(ids), torch.from_numpy(lens)
    if which == "lookup":
        idx = ids_t.long().clamp(0, v - 1).reshape(-1)
        fn = lambda x: bag_ops.embedding_lookup(x, idx)  # noqa: E731
    else:
        mode = which.split("_")[1]
        fn = lambda x: bag_ops.embedding_bag_autograd(  # noqa: E731
            x, ids_t, lens_t, mode)
    assert torch.autograd.gradcheck(fn, (t,))


def test_embedding_functions_backward_is_the_plain_backward_bitwise():
    """On the CPU the Functions' backward is ``embedding_bag_bwd_ref``, and
    their forward is the serving op's, bit for bit."""
    v, d, b, l, seed = BAG_CASES["wide"]
    table, ids, lens, grad = _bag_inputs(v, d, b, l, seed)
    ids_t, lens_t = torch.from_numpy(ids), torch.from_numpy(lens)
    t = torch.from_numpy(table).requires_grad_(True)
    out = bag_ops.embedding_bag_autograd(t, ids_t, lens_t, "mean")
    assert torch.equal(out.detach(), bag_ops.embedding_bag(
        torch.from_numpy(table), ids_t, lens_t, "mean"))
    out.backward(torch.from_numpy(grad))
    assert torch.equal(t.grad, embedding_bag_bwd_ref(
        torch.from_numpy(grad), ids_t, lens_t, "mean", v))
    idx = ids_t.long().clamp(0, v - 1).reshape(-1)
    t2 = torch.from_numpy(table).requires_grad_(True)
    g_rows = torch.from_numpy(_normal(5, (idx.numel(), d)))
    bag_ops.embedding_lookup(t2, idx).backward(g_rows)
    assert torch.equal(t2.grad, embedding_bag_bwd_ref(
        g_rows, idx.reshape(-1, 1), torch.ones(idx.numel(), dtype=torch.int32),
        "sum", v))


def test_sorted_slots_order_is_id_then_bag_then_slot():
    v, d, b, l, seed = BAG_CASES["ragged"]
    _, ids, lens, _ = _bag_inputs(v, d, b, l, seed)
    keys, slots = sorted_slots(torch.from_numpy(ids), torch.from_numpy(lens),
                               v)
    want = sorted(
        ((min(max(int(ids[i, j]), 0), v - 1) if j < lens[i] else v, i * l + j)
         for i in range(b) for j in range(l)))
    assert [(int(k), int(s)) for k, s in zip(keys, slots)] == want
    assert keys.dtype == torch.int32 and slots.dtype == torch.int32


def test_embedding_bag_bwd_sums_each_row_in_slot_order():
    """A row's gradient is the left-to-right float32 sum of its slots'
    contributions in ascending (b, l): values whose sum depends on the
    order (1e8, 1, -1e8) give that order's sum exactly."""
    grad = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    ids = torch.tensor([[2], [2], [2], [0]], dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.int32)
    got = embedding_bag_bwd_ref(grad, ids, ones, "sum", 3)
    want = ((np.float32(0) + np.float32(1e8)) + np.float32(1.0)) \
        + np.float32(-1e8)
    assert float(got[2, 0]) == float(want) == 0.0
    assert float(got[0, 0]) == 1.0 and float(got[1, 0]) == 0.0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def test_bce_loss_matches_reference():
    logit = _normal(0, (64,), 4.0)
    label = (np.random.default_rng(1).random(64) < 0.3).astype(np.float32)
    got = rc.bce_loss(torch.from_numpy(logit), torch.from_numpy(label))
    want = jax_rc.bce_loss(jnp.asarray(logit), jnp.asarray(label))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_in_batch_softmax_loss_matches_reference():
    u = _normal(0, (48, 16))
    v = _normal(1, (48, 16))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    got = rc.in_batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(v))
    want = jax_rc.in_batch_softmax_loss(jnp.asarray(u), jnp.asarray(v),
                                        NULL_CTX)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def two_tower():
    jcfg = jax_reduce(*jax_get_arch("two-tower-retrieval"))
    cfg = reduce_config(*get_arch("two-tower-retrieval"))
    jparams = jax_tt.init(jcfg, jax.random.PRNGKey(0))
    params = recsys_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    vocabs = {t.name: t.vocab for t in cfg.tables}
    batch = recsys_batch(64, vocabs, hist_len=cfg.hist_len, seed=3)
    return jcfg, cfg, jparams, params, batch


def _jax_loss_f32(jcfg):
    """The reference's two-tower loss built from its own blocks at float32
    (its ``two_tower.py`` hard-codes bfloat16 towers)."""
    f32 = jnp.float32

    def loss(params, batch):
        ue = jax_rc.lookup(params, "user", batch["user"], NULL_CTX, f32)
        hb = jax_rc.bag_lookup(params, "hist_item", batch["hist"],
                               batch["hist_len"], NULL_CTX, mode="mean",
                               compute_dtype=f32)
        x = jax_rc.apply_mlp(params, "user_mlp",
                             jnp.concatenate([ue, hb], -1),
                             len(jcfg.mlp_dims))
        ie = jax_rc.lookup(params, "item", batch["item"], NULL_CTX, f32)
        v = jax_rc.apply_mlp(params, "item_mlp", ie, len(jcfg.mlp_dims))
        return jax_rc.in_batch_softmax_loss(jax_rc.l2norm(x),
                                            jax_rc.l2norm(v), NULL_CTX)

    return loss


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_two_tower_loss_and_grads_match_reference(two_tower, cdt):
    jcfg, cfg, jparams, params, batch = two_tower
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cdt == "float32":
        jl, jg = jax.value_and_grad(_jax_loss_f32(jcfg))(jparams, jb)
    else:
        (jl, _), jg = jax.value_and_grad(jax_tt.loss_fn, has_aux=True)(
            jparams, jb, jcfg, NULL_CTX)
    loss, metrics, grads = _grads(
        tt.loss_fn, params, tb, dataclasses.replace(cfg, compute_dtype=cdt))
    assert metrics == {}
    want = {(k,): np.asarray(v, np.float32) for k, v in jg.items()}
    if cdt == "float32":
        np.testing.assert_allclose(float(loss), float(jl), rtol=F32_RTOL)
        _assert_leaves_close(grads, want, F32_RTOL)
    else:
        np.testing.assert_allclose(float(loss), float(jl), rtol=BF16_LOSS)
        _assert_leaves_close(grads, want, TT_BF16_GRAD)


def _dense_cfgs(**kw):
    """The reference's ``tests/test_transformer.py:dense_cfg`` (vocab 97,
    padded to 256, qkv bias, qk norm) in both packages; the port's with
    per-layer remat on."""
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=128, vocab_size=97,
                qkv_bias=True, qk_norm=True, scan_layers=True, kv_chunk=8)
    base.update(kw)
    return (JaxTransformerConfig(remat=False, **base),
            TransformerConfig(remat=True, **base))


def _lm_case(jcfg, seed=1, b=2, s=16):
    jparams = jax_tm.init(jcfg, jax.random.PRNGKey(0))
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return jparams, params, batch


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie", [True, False])
def test_lm_loss_and_grads_match_reference_with_padded_vocab(tie, cdt):
    """The reference's ``test_vocab_padding_masked_in_loss`` case (vocab 97
    padded to 256: padded columns masked to -1e30 before the logsumexp),
    tied and untied heads: the loss and every gradient."""
    jcfg, cfg = _dense_cfgs(tie_embeddings=tie, compute_dtype=cdt,
                            xent_chunk=8)
    jparams, params, batch = _lm_case(jcfg)
    (jl, jm), jg = jax.value_and_grad(jax_tm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        NULL_CTX)
    loss, metrics, grads = _grads(
        tm.loss_fn, params, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, cfg)
    assert float(metrics["xent"]) == float(loss)
    assert float(loss) < np.log(97) + 1.0
    if cdt == "float32":
        np.testing.assert_allclose(float(loss), float(jl), rtol=F32_RTOL)
        _assert_leaves_close(grads, _jax_leaves(jg), F32_RTOL)
    else:
        np.testing.assert_allclose(float(loss), float(jl), rtol=BF16_LOSS)
        _assert_leaves_close(grads, _jax_leaves(jg), LM_BF16_GRAD)


def test_lm_loss_of_zero_tokens_stays_under_log_vocab():
    """The reference test itself: at init, all-zero tokens, the masked
    padded columns keep the loss near log(97)."""
    _, cfg = _dense_cfgs()
    params = tm.init(cfg, 0, "cpu")
    b = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
         "targets": torch.zeros((2, 16), dtype=torch.int32)}
    loss, m = tm.loss_fn(params, b, cfg)
    assert float(m["xent"]) < np.log(97) + 1.0


class _Recorder:
    """An optimizer stand-in that keeps the gradients it is given."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state, {}


@pytest.mark.parametrize("ga", [1, 2])
def test_lm_train_step_grads_match_reference(ga):
    """``make_train_step``'s gradients on a reduced llama (float32 compute):
    with ``grad_accum = 2`` both packages sum the microbatches' gradients in
    bfloat16 and divide in float32."""
    jcfg = dataclasses.replace(jax_reduce(*jax_get_arch("llama3.2-1b")),
                               compute_dtype="float32", grad_accum=ga)
    cfg = dataclasses.replace(reduce_config(*get_arch("llama3.2-1b")),
                              compute_dtype="float32", grad_accum=ga)
    jparams, params, batch = _lm_case(jcfg, seed=2, b=4, s=16)
    jrec, rec = _Recorder(), _Recorder()
    _, _, jm = jax_tm.make_train_step(jcfg, NULL_CTX, jrec)(
        jparams, None, {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, m = tm.make_train_step(cfg, rec)(
        params, None, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=F32_RTOL)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=F32_RTOL)
    got = {p: g.numpy() for p, g in flatten_with_path(rec.grads)}
    _assert_leaves_close(got, _jax_leaves(jrec.grads),
                         F32_RTOL if ga == 1 else ACCUM_REL)


def test_adamw_on_a_parameter_tree_matches_reference():
    """The LM optimizer (warmup, clip, weight decay, bfloat16 moments) on a
    nested parameter tree, from the reference's gradients and a state a few
    steps in: new params and moments to float32 rounding."""
    jcfg = jax_reduce(*jax_get_arch("llama3.2-1b"))
    cfg = reduce_config(*get_arch("llama3.2-1b"))
    jparams, params, _ = _lm_case(jcfg)
    grads_np = jax.tree.map(
        lambda p: _normal(int(p.size) % 97, p.shape, 0.1), jparams)
    jopt, opt = jax_reg._lm_opt(jcfg), registry._lm_opt(cfg)
    jst = jopt.init(jparams)._replace(step=jnp.asarray(600, jnp.int32))
    st = opt.init(params)._replace(step=torch.tensor(600, dtype=torch.int32))
    jp2, jst2, jm = jopt.update(jax.tree.map(jnp.asarray, grads_np), jst,
                                jparams)
    p2, st2, m = opt.update(transformer_params_from_jax(grads_np, "cpu"), st,
                            params)
    assert int(st2.step) == int(jst2.step) == 601
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert st2.m["embed"].dtype == torch.bfloat16
    lr = float(jm["lr"])
    for got, want, rtol, atol in ((p2, jp2, 1e-6, lr * 2.0 ** -6),
                                  (st2.m, jst2.m, 2.0 ** -7, 0.0),
                                  (st2.v, jst2.v, 2.0 ** -7, 0.0)):
        w = _jax_leaves(want)
        for path, leaf in flatten_with_path(got):
            np.testing.assert_allclose(leaf.float().numpy(), w[path],
                                       rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the train cells
# ---------------------------------------------------------------------------
def _reference_cell(arch):
    jcfg, fam = jax_get_arch(arch)
    jcfg = jax_reduce(jcfg, fam)
    cell = jax_reduce_cell([c for c in jax_reg.get_shapes(arch)
                            if c.kind == "train"][0], fam)
    if fam == "lm":
        prog, opt = jax_reg._lm_cell(arch, jcfg, cell, NULL_CTX), \
            jax_reg._lm_opt(jcfg)
    else:
        prog, opt = jax_reg._recsys_cell(arch, jcfg, cell, NULL_CTX), \
            jax_reg._small_opt()
    return jcfg, fam, cell, jax.jit(prog.fn), opt


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "llama3.2-1b"])
def test_three_steps_of_each_train_cell_match_reference(arch, monkeypatch):
    jcfg, fam, jcell, jfn, jopt = _reference_cell(arch)
    cfg = reduce_config(*get_arch(arch))
    monkeypatch.setattr(registry, "get_arch", lambda a: (cfg, fam))
    cell = registry.build_cell(arch, reduce_cell(
        [c for c in get_shapes(arch) if c.kind == "train"][0], fam), "cpu")
    assert cell.cell.kind == "train" and cell.init_opt is not None
    if fam == "lm":
        jparams = jax_tm.init(jcfg, jax.random.PRNGKey(0))
        params = transformer_params_from_jax(
            jax.tree.map(np.asarray, jparams), "cpu")
    else:
        jparams = jax_tt.init(jcfg, jax.random.PRNGKey(0))
        params = recsys_params_from_jax(
            {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jst, st = jopt.init(jparams), cell.init_opt(params)
    bar = BF16_LOSS if fam == "lm" else 1e-2
    for step in range(3):
        (batch,) = cell.make_inputs(step)
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        jparams, jst, jm = jfn(jparams, jst, jbatch)
        params, st, m = cell.fn(params, st, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=bar)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(st.step) == int(jst.step) == step + 1
    assert _jax_leaves(jparams).keys() == \
        {p for p, _ in flatten_with_path(params)}


def test_train_batch_is_the_reference_launchers_draw():
    """``registry.train_batch`` at seed s is the reference launcher's
    ``make_batch_fn(..., seed=0)(s)``."""
    from repro.launch.train import make_batch_fn as jax_make_batch_fn

    for arch in ("two-tower-retrieval", "llama3.2-1b"):
        jcfg, fam = jax_get_arch(arch)
        jcfg = jax_reduce(jcfg, fam)
        cfg = reduce_config(*get_arch(arch))
        cell = reduce_cell([c for c in get_shapes(arch)
                            if c.kind == "train"][0], fam)
        want = jax_make_batch_fn(arch, jcfg, fam, cell, seed=0)(3)
        got = registry.train_batch(cfg, fam, cell, 3, "cpu")
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# data pipeline (the reference's tests/test_search_extra.py cases)
# ---------------------------------------------------------------------------
def test_prefetcher_order_and_close():
    src = StepIndexedSource(lambda step: step * step, seed=0)
    it = Prefetcher(iter([src.batch_at(i) for i in range(10)]), depth=2)
    assert list(it) == [i * i for i in range(10)]
    it2 = Prefetcher(src.iterate(), depth=2)
    assert next(it2) == 0
    it2.close()


def test_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise ValueError("boom")

    it = Prefetcher(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError):
        for _ in it:
            pass


def test_step_indexed_source_resumable():
    src = StepIndexedSource(
        lambda step: np.random.default_rng(step).normal(size=4), seed=0)
    a = list(x.sum() for x in [src.batch_at(i) for i in range(3, 6)])
    it = src.iterate(start_step=3)
    b = [next(it).sum() for _ in range(3)]
    assert a == b


def test_to_device_keeps_values_and_dtypes():
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "label": np.array([0.5, 1.0], np.float32)}
    out = to_device(batch, "cpu")
    for k, v in batch.items():
        assert out[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(out[k].numpy(), v)


# ---------------------------------------------------------------------------
# the paper's RAE config
# ---------------------------------------------------------------------------
def test_rae_paper_config_is_the_reference_one():
    cfg, fam = get_arch("rae_paper")
    jcfg, jfam = jax_get_arch("rae_paper")
    assert isinstance(cfg, RAEConfig) and fam == jfam == "rae"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_shapes("rae_paper") == ()
    from repro_torch.configs.registry import ARCH_IDS
    assert "rae_paper" not in ARCH_IDS
    with pytest.raises(NotImplementedError, match="item 3"):
        launch_train.main(["--arch", "rae_paper", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["two-tower-retrieval", "llama3.2-1b"])
def test_launcher_smoke_on_cpu_crash_and_resume_bitwise(arch, tmp_path,
                                                        capsys):
    """``--scale smoke --device cpu`` trains; a run crashed at step 9 and
    resumed from its step-8 checkpoint ends in the uninterrupted run's
    state, file for file."""
    common_args = ["--arch", arch, "--scale", "smoke", "--device", "cpu",
                   "--steps", "12", "--save-every", "4"]
    whole, crash = tmp_path / "whole", tmp_path / "crash"
    assert launch_train.main(common_args
                             + ["--checkpoint-dir", str(whole)]) == 0
    assert launch_train.main(common_args + ["--checkpoint-dir", str(crash),
                                            "--fail-at-step", "9"]) == 3
    assert "injected failure at step 9" in capsys.readouterr().out
    assert launch_train.main(common_args
                             + ["--checkpoint-dir", str(crash)]) == 0
    assert "at step 8" in capsys.readouterr().out
    a, b = whole / "step_00000012", crash / "step_00000012"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_launcher_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        launch_train.main(["--arch", "llama3.2-1b", "--steps", "1"])
    with pytest.raises(SystemExit, match="on the card"):
        launch_train.main(["--arch", "llama3.2-1b", "--scale", "full",
                           "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 15"):
        launch_train.main(["--arch", "bst", "--device", "cpu"])


def test_full_scale_reckoning_refuses_the_published_cells_on_one_card():
    """``reckon_bytes`` at the published cells: far past 80 GB for both
    (llama3.2-1b train_4k at B = 256, two-tower train_batch with its 25.6
    GB of tables and B = 65,536), and the cuts ``chip_smoke.py`` phase 11
    runs fit."""
    lm_cfg, _ = get_arch("llama3.2-1b")
    lm_cell = [c for c in get_shapes("llama3.2-1b") if c.kind == "train"][0]
    tt_cfg, _ = get_arch("two-tower-retrieval")
    tt_cell = [c for c in get_shapes("two-tower-retrieval")
               if c.kind == "train"][0]
    assert launch_train.reckon_bytes(lm_cfg, "lm", lm_cell)["peak"] > 1e12
    assert launch_train.reckon_bytes(tt_cfg, "recsys", tt_cell)["peak"] > 1e11
    cut = launch_train.reckon_bytes(lm_cfg, "lm",
                                    lm_cell.replace(global_batch=2))
    assert 2e10 < cut["peak"] < 8e10
    assert 4.9e9 < cut["params"] < 5e9     # 1.236B float32 parameters
