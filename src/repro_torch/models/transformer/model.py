"""Decoder-only transformer LM, dense family: GQA, RoPE, SwiGLU, prefill
and KV-cache decode, on one device.

The reference's ``models/transformer/model.py`` without its mesh
(sequence-parallel residual stream, tensor-parallel projections, the
sequence-sharded decode cache). Parameters keep the reference's stacked
``[L, ...]`` layer layout; the layers run as a Python loop over the stack
where the reference scans it.

Training: ``loss_fn`` is the reference's token-chunked cross entropy (each
chunk's logits recomputed in the backward, ``torch.utils.checkpoint``
where the reference has ``jax.checkpoint``), ``make_train_step`` its step
with AdamW and the ``grad_accum`` microbatches (grads summed in bfloat16,
as the reference sums them). With ``cfg.remat`` and grad on,
``forward_hidden`` recomputes each layer in the backward, keeping only the
residual stream between layers. The token embedding's gradient is the
``embedding_bag_bwd`` kernel (``models/common.py``).

``prefill`` returns the last token's logits, the pooled, normalized
document embedding (what ``examples/lm_embedding_compression.py`` feeds to
the RAE) and a ``DecodeState``. ``decode_step`` writes each layer's new K
and V into the state's cache **in place** and returns the state with
``length + 1``; ``length`` is an int32 tensor on the device, read there by
RoPE, the cache write and the ``flash_decode`` kernel, so a decode step
never waits on the host. The MoE family (``moe.py``) is not ported
(ROADMAP.md queue A item 15).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ...configs.base import TransformerConfig
from ...distributed.partitioning import ParamDef, init_from_schema
from ...pytree import tree_map
from ..common import (dtype_of, pad_to_multiple, rms_norm,
                      sharded_embedding_lookup, value_and_grad)
from . import attention as attn_lib

VOCAB_PAD = 256
MOE_NOT_PORTED = ("the MoE family (models/transformer/moe.py: routed "
                  "experts) is not ported: ROADMAP.md queue A item 15")


def _require_dense(cfg: TransformerConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(MOE_NOT_PORTED)


def padded_vocab(cfg: TransformerConfig) -> int:
    return pad_to_multiple(cfg.vocab_size, VOCAB_PAD)


# ---------------------------------------------------------------------------
# Schema / init
# ---------------------------------------------------------------------------
def schema(cfg: TransformerConfig) -> dict:
    _require_dense(cfg)
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head
    h, kh = cfg.n_heads, cfg.n_kv_heads
    pdt = dtype_of(cfg.param_dtype)
    v = padded_vocab(cfg)
    f = cfg.d_ff
    layers: dict[str, ParamDef] = {
        "ln1": ParamDef((L, d), ("stack", None), pdt, init="ones"),
        "wq": ParamDef((L, d, h * dh), ("stack", "embed_fsdp", "qkv_out"), pdt),
        "wk": ParamDef((L, d, kh * dh), ("stack", "embed_fsdp", "qkv_out"), pdt),
        "wv": ParamDef((L, d, kh * dh), ("stack", "embed_fsdp", "qkv_out"), pdt),
        "wo": ParamDef((L, h * dh, d), ("stack", "qkv_out", "embed_fsdp"), pdt),
        "ln2": ParamDef((L, d), ("stack", None), pdt, init="ones"),
    }
    if cfg.qkv_bias:
        layers["bq"] = ParamDef((L, h * dh), ("stack", "qkv_out"), pdt,
                                init="zeros")
        layers["bk"] = ParamDef((L, kh * dh), ("stack", "qkv_out"), pdt,
                                init="zeros")
        layers["bv"] = ParamDef((L, kh * dh), ("stack", "qkv_out"), pdt,
                                init="zeros")
    if cfg.qk_norm:
        layers["q_norm"] = ParamDef((L, dh), ("stack", None), pdt, init="ones")
        layers["k_norm"] = ParamDef((L, dh), ("stack", None), pdt, init="ones")
    layers["wg"] = ParamDef((L, d, f), ("stack", "embed_fsdp", "mlp"), pdt)
    layers["wu"] = ParamDef((L, d, f), ("stack", "embed_fsdp", "mlp"), pdt)
    layers["wd"] = ParamDef((L, f, d), ("stack", "mlp", "embed_fsdp"), pdt)
    out = {
        "layers": layers,
        "embed": ParamDef((v, d), ("vocab", None), pdt, init="embed"),
        "final_ln": ParamDef((d,), (None,), pdt, init="ones"),
    }
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((d, v), ("embed_fsdp", "vocab"), pdt,
                               init="normal")
    return out


def init(cfg: TransformerConfig, seed: int = 0,
         device: str | torch.device = "cuda") -> dict:
    return init_from_schema(schema(cfg), seed, device)


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------
def _project_qkv(h_ln, lp, cfg: TransformerConfig, cdt):
    """QKV projections (+ bias, + per-head RMS norm) -> [B, S, heads, dh]."""
    b, s, _ = h_ln.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = h_ln @ lp["wq"].to(cdt)
    k = h_ln @ lp["wk"].to(cdt)
    v = h_ln @ lp["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cdt)
        k = k + lp["bk"].to(cdt)
        v = v + lp["bv"].to(cdt)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kh, dh)
    v = v.reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return q, k, v


def _mlp(h2, lp, cdt):
    g = h2 @ lp["wg"].to(cdt)
    u = h2 @ lp["wu"].to(cdt)
    return (torch.nn.functional.silu(g.float()).to(cdt) * u) \
        @ lp["wd"].to(cdt)


def decoder_layer(x, lp, cfg: TransformerConfig, positions):
    """One pre-norm block over a whole sequence. x: [B, S, d]. Returns
    (x, (k, v)): the layer's RoPE'd keys and values in the compute dtype,
    the cache a prefill keeps."""
    _require_dense(cfg)
    b, s, _ = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    h_ln = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h_ln, lp, cfg, cdt)
    q = attn_lib.apply_rope(q, positions[None, :], cfg.rope_theta)
    k = attn_lib.apply_rope(k, positions[None, :], cfg.rope_theta)
    o = attn_lib.flash_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk)
    x = x + o.reshape(b, s, cfg.n_heads * cfg.d_head) @ lp["wo"].to(cdt)
    x = x + _mlp(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cdt)
    return x, (k.to(cdt), v.to(cdt))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _cast_layer_stack(layers: dict, cfg: TransformerConfig) -> dict:
    """One cast of the float32 layer stack to the compute dtype before the
    layer loop (a no-op for serving weights, which are kept in it)."""
    cdt = dtype_of(cfg.compute_dtype)
    return {k: (v.to(cdt) if v.dtype == torch.float32 else v)
            for k, v in layers.items()}


def _unstack(layers: dict) -> list[dict]:
    """The stack as one dict a layer (views; autograd stacks the layers'
    gradients once, where indexing would add a zero-filled stack a
    layer)."""
    parts = {k: v.unbind(0) for k, v in layers.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _layer_out(x, lp, cfg: TransformerConfig, positions):
    return decoder_layer(x, lp, cfg, positions)[0]


def forward_hidden(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
                   emit_cache: bool = False, max_len: Optional[int] = None):
    """tokens [B, S] -> (hidden [B, S, d] after the final norm, cache).
    With ``emit_cache`` the cache is (k, v) ``[L, B, Smax, kh, dh]`` in the
    compute dtype, positions ``< S`` filled and the rest zero, ``Smax =
    max_len or S``; else None. (The reference also returns its MoE
    statistics, which the dense family does not have.) With ``cfg.remat``
    and grad enabled each layer runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward, as the reference's
    ``jax.checkpoint(nothing_saveable)`` recomputes them."""
    _require_dense(cfg)
    b, s = tokens.shape
    cdt = dtype_of(cfg.compute_dtype)
    dev = params["embed"].device
    x = sharded_embedding_lookup(params["embed"], tokens.to(dev), cdt)
    positions = torch.arange(s, device=dev)
    layers = _unstack(_cast_layer_stack(params["layers"], cfg))
    cache = None
    if emit_cache:
        smax = max(max_len or s, s)
        shape = (cfg.n_layers, b, smax, cfg.n_kv_heads, cfg.d_head)
        cache = (torch.zeros(shape, dtype=cdt, device=dev),
                 torch.zeros(shape, dtype=cdt, device=dev))
    remat = cfg.remat and torch.is_grad_enabled() and not emit_cache
    for i, lp in enumerate(layers):
        if remat:
            x = checkpoint(_layer_out, x, lp, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        x, (k, v) = decoder_layer(x, lp, cfg, positions)
        if emit_cache:
            cache[0][i, :, :s] = k
            cache[1][i, :, :s] = v
    return rms_norm(x, params["final_ln"], cfg.norm_eps), cache


def _head_matrix(params, cfg: TransformerConfig, cdt) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].to(cdt).T  # [d, Vp]
    return params["head"].to(cdt)


# ---------------------------------------------------------------------------
# Loss / train step
# ---------------------------------------------------------------------------
def _xent_chunk(h_c: torch.Tensor, t_c: torch.Tensor, w: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """Summed cross entropy of one token chunk: h_c [B, C, d], t_c [B, C],
    w [d, Vp]. Padded vocab columns (``>= vocab``) are set to -1e30 before
    the logsumexp; the gold logit is picked by column equality."""
    logits = (h_c @ w).float()                                # [B, C, Vp]
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab, logits,
                         torch.full_like(logits, -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.sum(torch.where(col == t_c[..., None], logits,
                                 torch.zeros_like(logits)), dim=-1)
    return torch.sum(lse - gold)


def loss_fn(params, batch, cfg: TransformerConfig):
    """Token-chunked causal-LM cross entropy: ``(loss, {"xent": loss})``
    for ``batch["tokens"]`` and ``batch["targets"]`` [B, S]. Chunks of
    ``cfg.xent_chunk or min(S, 512)`` tokens; each chunk's logits are
    recomputed in the backward (``torch.utils.checkpoint``), so no more
    than one chunk's ``[B, C, Vp]`` logits live at once."""
    _require_dense(cfg)
    tokens, targets = batch["tokens"], batch["targets"]
    b, s = tokens.shape
    cdt = dtype_of(cfg.compute_dtype)
    hidden, _ = forward_hidden(params, tokens, cfg)
    w = _head_matrix(params, cfg, cdt)                        # [d, Vp]
    c = cfg.xent_chunk or min(s, 512)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"cross-entropy chunk {c}")
    targets = targets.to(hidden.device)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        total = total + checkpoint(_xent_chunk, hidden[:, c0:c0 + c],
                                   targets[:, c0:c0 + c], w, cfg.vocab_size,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    xent = total / torch.full((), b * s, dtype=torch.float32,
                              device=total.device)
    return xent, {"xent": xent}


def make_train_step(cfg: TransformerConfig, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss, grads, one ``opt.update``. With ``cfg.grad_accum =
    ga > 1`` the batch is split into ``ga`` microbatches along its first
    dimension; their grads are summed in bfloat16 (the reference's
    accumulator) and divided by ``ga`` in float32, and the loss and
    metrics are the microbatches' means."""
    ga = max(cfg.grad_accum, 1)

    if ga == 1:
        def train_step(params, opt_state, batch):
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    cfg)
            params, opt_state, om = opt.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, **metrics, **om}

        return train_step

    def train_step(params, opt_state, batch):
        micro = {k: v.reshape((ga, v.shape[0] // ga) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                              device=p.device), params)
        lsum, msum = None, {}
        for i in range(ga):
            mb = {k: v[i] for k, v in micro.items()}
            (loss, metrics), g = value_and_grad(loss_fn, params, mb, cfg)
            gsum = tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
            lsum = loss if lsum is None else lsum + loss
            msum = {k: v if k not in msum else msum[k] + v
                    for k, v in metrics.items()}
        n = torch.full((), ga, dtype=torch.float32, device=lsum.device)
        grads = tree_map(lambda g: g.float() / n, gsum)
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = {k: v / n for k, v in msum.items()}
        return params, opt_state, {"loss": lsum / n, **metrics, **om}

    return train_step


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    k: torch.Tensor       # [L, B, Smax, kh, dh]
    v: torch.Tensor
    length: torch.Tensor  # int32 scalar on the cache's device


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: Optional[int] = None):
    """Returns (last-token logits [B, Vp] float32, pooled embedding [B, d]
    float32 with unit rows, DecodeState). The state's cache holds ``Smax =
    max_len or S`` positions, so ``Smax - S`` decode steps fit in it."""
    hidden, cache = forward_hidden(params, tokens, cfg, emit_cache=True,
                                      max_len=max_len)
    cdt = dtype_of(cfg.compute_dtype)
    last = hidden[:, -1, :]
    logits = (last @ _head_matrix(params, cfg, cdt)).float()
    embed = _normalize(hidden.float().mean(dim=1))
    state = DecodeState(k=cache[0], v=cache[1],
                        length=torch.tensor(tokens.shape[1],
                                            dtype=torch.int32,
                                            device=hidden.device))
    return logits, embed, state


def decode_layer(x, lp, k_cache, v_cache, cur_len, cfg: TransformerConfig):
    """Single-token decode block. x: [B, d]; caches [B, Smax, kh, dh],
    updated in place at ``cur_len``."""
    _require_dense(cfg)
    b, _ = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    h_ln = rms_norm(x, lp["ln1"], cfg.norm_eps)[:, None, :]  # [B, 1, d]
    q, k, v = _project_qkv(h_ln, lp, cfg, cdt)
    pos = cur_len.reshape(1, 1)
    q = attn_lib.apply_rope(q, pos, cfg.rope_theta)
    k = attn_lib.apply_rope(k, pos, cfg.rope_theta)
    q, k_new, v_new = q[:, 0], k[:, 0].to(cdt), v[:, 0].to(cdt)
    o, k_cache, v_cache = attn_lib.decode_attention(
        q, k_cache, v_cache, k_new, v_new, cur_len)
    x = x + o.reshape(b, cfg.n_heads * cfg.d_head) @ lp["wo"].to(cdt)
    x = x + _mlp(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cdt)
    return x, (k_cache, v_cache)


def decode_step(params, state: DecodeState, tokens: torch.Tensor,
                cfg: TransformerConfig):
    """One decode step: tokens [B] -> (logits [B, Vp] float32, embed
    [B, d], the state with ``length + 1``). The state's cache is written in
    place (the reference returns new stacked arrays)."""
    cdt = dtype_of(cfg.compute_dtype)
    dev = params["embed"].device
    x = sharded_embedding_lookup(params["embed"], tokens.to(dev), cdt)
    cur_len = state.length
    layers = _unstack(_cast_layer_stack(params["layers"], cfg))
    for i, lp in enumerate(layers):
        x, _ = decode_layer(x, lp, state.k[i], state.v[i], cur_len, cfg)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = (x @ _head_matrix(params, cfg, cdt)).float()
    embed = _normalize(x.float())
    return logits, embed, DecodeState(k=state.k, v=state.v,
                                      length=cur_len + 1)
