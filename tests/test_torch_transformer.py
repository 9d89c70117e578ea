"""Parity of the port's dense transformer serving path
(``repro_torch.models.transformer``: RoPE, blockwise attention, decode
attention through ``flash_decode``, prefill and decode steps) with the
reference package, on the CPU.

The reference's weights are drawn with JAX and carried across with
``convert.transformer_params_from_jax``; tokens are made with numpy. On the
CPU the port's decode attention runs the plain version of the
``flash_decode`` kernel. The reference runs its own model code, which on
one device is XLA (no Pallas kernel).

Tolerances:
- RoPE, blockwise attention and decode attention in float32: ``rtol=2e-4,
  atol=2e-5`` (float32 softmax sums in another order; the decode order
  differs too: the port writes the new token, then attends, where the
  reference attends, then merges the new token in);
- prefill and decode at ``compute_dtype="float32"``: logits within
  ``1e-4`` of the largest logit, embeddings and cache within ``1e-5``;
- the same in bfloat16 (the serving dtype): within 0.06 of the largest
  logit, the reference's own decode-vs-forward bar
  (``tests/test_transformer.py:60``); the cache within ``2 ** -6`` of its
  largest entry, about four bfloat16 steps there (a one-step difference
  in a projection, rotated by RoPE, lands on a smaller entry).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import TransformerConfig as JaxTCfg  # noqa: E402
from repro.configs.reduce import reduce_config as jax_reduce  # noqa: E402
from repro.models.common import NULL_CTX  # noqa: E402
from repro.models.transformer import attention as jax_attn  # noqa: E402
from repro.models.transformer import model as jax_tm  # noqa: E402
from repro_torch.configs import TransformerConfig, get_arch  # noqa: E402
from repro_torch.configs.reduce import reduce_config  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.data import token_batch  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.registry import build_cell  # noqa: E402
from repro_torch.models.transformer import attention as attn  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 2e-4, 2e-5
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.06}


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _dense(**kw):
    """The reference's dense test model (tests/test_transformer.py:17):
    qkv bias, per-head q/k norm, GQA 4/2, kv_chunk 8."""
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=128, vocab_size=97,
                qkv_bias=True, qk_norm=True, remat=False, scan_layers=True,
                kv_chunk=8)
    base.update(kw)
    return TransformerConfig(**base), JaxTCfg(**base)


def _llama(**kw):
    cfg = reduce_config(*get_arch("llama3.2-1b"))
    jcfg = jax_reduce(*jax_get_arch("llama3.2-1b"))
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)


MODELS = {"dense_bias_qknorm": _dense, "llama3.2-1b_reduced": _llama}


def _assert_cache_close(got, want, cdt):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if cdt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------
def test_apply_rope_matches_the_reference():
    x = _normal(0, (2, 9, 3, 32))
    pos = np.array([[0, 1, 2, 5, 17, 100, 511, 4096, 30000]] * 2)
    got = attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          500_000.0)
    want = jax_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        attn.rope_frequencies(32, 10_000.0, "cpu").numpy(),
        np.asarray(jax_attn.rope_frequencies(32, 10_000.0)), rtol=1e-6)


@pytest.mark.parametrize("b,s,t,h,kh,chunk,off", [
    (2, 24, 24, 6, 2, 8, 0),     # GQA g=3, chunked
    (1, 8, 27, 4, 4, 8, 19),     # chunked prefill: q_offset, ragged T
    (2, 5, 5, 8, 2, 256, 0),     # one chunk wider than T
])
def test_flash_attention_matches_the_reference(b, s, t, h, kh, chunk, off):
    q, k, v = (_normal(i, shape) for i, shape in
               enumerate([(b, s, h, 16), (b, t, kh, 16), (b, t, kh, 16)]))
    got = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True, q_offset=off,
                               kv_chunk=chunk)
    want = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    q_offset=off, kv_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_flash_attention_in_bfloat16():
    q, k, v = (_normal(i + 3, shape) for i, shape in
               enumerate([(2, 16, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16)]))
    got = attn.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)), kv_chunk=8)
    want = jax_attn.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                      for a in (q, k, v)), kv_chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("cur", [0, 1, 20, 31])
def test_decode_attention_matches_the_reference(cur):
    """Write the new token, then attend (the port) == attend, then merge the
    new token in (the reference); the cache is updated in place."""
    b, kh, g, dh, s = 2, 2, 3, 16, 32
    q = _normal(0, (b, kh * g, dh))
    kc, vc = _normal(1, (b, s, kh, dh)), _normal(2, (b, s, kh, dh))
    kn, vn = _normal(3, (b, kh, dh)), _normal(4, (b, kh, dh))
    want, k2, v2 = jax_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(cur, jnp.int32), NULL_CTX)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, k3, v3 = attn.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.tensor(cur, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert k3 is tk and v3 is tv                          # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _both(make, cdt):
    cfg, jcfg = make(compute_dtype=cdt)
    jparams = jax_tm.init(jcfg, jax.random.PRNGKey(1))
    params = transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_and_decode_match_the_reference(model, cdt):
    cfg, jcfg, jparams, params = _both(MODELS[model], cdt)
    b, p, steps, smax = 2, 8, 4, 16
    toks = token_batch(b, p + steps, cfg.vocab_size, seed=3)["tokens"]
    jl, je, jst = jax.jit(lambda pr, t: jax_tm.prefill(pr, t, jcfg,
                                                       NULL_CTX))(
        jparams, jnp.asarray(toks[:, :p]))
    tl, te, tst = tm.prefill(params, torch.from_numpy(toks[:, :p]), cfg,
                             max_len=smax)
    tol = LOGIT_TOL[cdt]
    assert tl.shape == (b, tm.padded_vocab(cfg)) and tl.dtype == torch.float32
    assert _rel(tl.numpy(), jl) < tol
    np.testing.assert_allclose(te.numpy(), np.asarray(je),
                               atol=1e-5 if cdt == "float32" else 2e-2)
    assert tst.k.shape == (cfg.n_layers, b, smax, cfg.n_kv_heads, cfg.d_head)
    assert int(tst.length) == p and tst.length.dtype == torch.int32
    for got, want in ((tst.k, jst.k), (tst.v, jst.v)):
        _assert_cache_close(got[:, :, :p], want, cdt)
        assert torch.all(got[:, :, p:] == 0)
    # the reference's cache padded to Smax, as its own decode test pads it
    pad = ((0, 0), (0, 0), (0, smax - p), (0, 0), (0, 0))
    jst = jax_tm.DecodeState(k=jnp.pad(jst.k, pad), v=jnp.pad(jst.v, pad),
                             length=jst.length)
    jstep = jax.jit(lambda pr, s, t: jax_tm.decode_step(pr, s, t, jcfg,
                                                        NULL_CTX))
    k_buf = tst.k
    for i in range(steps):
        jl, je, jst = jstep(jparams, jst, jnp.asarray(toks[:, p + i]))
        tl, te, tst = tm.decode_step(params, tst,
                                     torch.from_numpy(toks[:, p + i]), cfg)
        assert _rel(tl.numpy(), jl) < tol, (i, _rel(tl.numpy(), jl))
        assert int(tst.length) == int(jst.length) == p + i + 1
        assert tst.k is k_buf                             # in place
    _assert_cache_close(tst.k[:, :, :p + steps], jst.k[:, :, :p + steps],
                        cdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_decode_matches_the_forward_over_the_same_tokens(cdt):
    """The port's own consistency: logits of decode steps == the prefill
    forward's logits at the same positions."""
    cfg, _ = _dense(compute_dtype=cdt)
    params = tm.init(cfg, seed=2, device="cpu")
    b = 2
    toks = torch.from_numpy((np.arange(b * 16).reshape(b, 16) * 7)
                            % cfg.vocab_size)
    _, _, st = tm.prefill(params, toks[:, :8], cfg, max_len=16)
    hidden, _ = tm.forward_hidden(params, toks[:, :13], cfg)
    w = tm._head_matrix(params, cfg, getattr(torch, cdt))
    for pos in range(8, 12):
        logits, _, st = tm.decode_step(params, st, toks[:, pos], cfg)
        want = (hidden[:, pos] @ w).float()
        assert _rel(logits.numpy(), want.numpy()) < LOGIT_TOL[cdt]


def test_untied_head_matches_the_reference():
    cfg, jcfg, jparams, params = _both(
        lambda **kw: _dense(tie_embeddings=False, qkv_bias=False,
                            qk_norm=False, **kw), "float32")
    assert "head" in params and params["head"].shape == (64, 256)
    toks = token_batch(2, 8, cfg.vocab_size, seed=5)["tokens"]
    jl, _, _ = jax_tm.prefill(jparams, jnp.asarray(toks), jcfg, NULL_CTX)
    tl, _, _ = tm.prefill(params, torch.from_numpy(toks), cfg)
    assert _rel(tl.numpy(), jl) < LOGIT_TOL["float32"]


def test_decode_cell_runs_from_a_seeded_cache(monkeypatch):
    cfg = reduce_config(*get_arch("llama3.2-1b"))
    monkeypatch.setattr(registry, "get_arch", lambda arch: (cfg, "lm"))
    cell = build_cell("llama3.2-1b", "long_500k", device="cpu")
    cell.cell = cell.cell.replace(seq_len=64)
    small = build_cell("llama3.2-1b", cell.cell, device="cpu")
    params = small.init(0)
    assert params["embed"].dtype == torch.bfloat16   # serving weights
    state, toks = small.make_inputs(0)
    assert int(state.length) == 64 - 16 and toks.shape == (1,)
    for _ in range(3):
        logits, emb, state = small.fn(params, state, toks)
        toks = logits[:, :cfg.vocab_size].argmax(-1)
    assert int(state.length) == 64 - 13
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(),
                               1.0, rtol=1e-5)


def test_moe_names_its_roadmap_item():
    cfg, _ = _dense()
    moe = dataclasses.replace(cfg, family="moe", n_experts=4, moe_top_k=2)
    for fn in (lambda: tm.schema(moe), lambda: tm.init(moe, 0, "cpu")):
        with pytest.raises(NotImplementedError, match="item 15"):
            fn()
    params = tm.init(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        tm.forward_hidden(params, torch.zeros(1, 4, dtype=torch.long), moe)
