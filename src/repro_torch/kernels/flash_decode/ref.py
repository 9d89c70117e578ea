"""Plain PyTorch version of one-token GQA decode attention over a KV cache.

q ``[B, kh, g, dh]`` (kh-major grouped heads), caches ``[B, S, kh, dh]``,
attending to cache positions ``< cur_len``: scores ``(q * dh^-0.5) . k`` in
float32, dead positions set to ``NEG_INF`` and weighted by zero, output
``acc / max(l, 1e-30)``. That is the TPU kernel's arithmetic
(``src/repro/kernels/flash_decode/kernel.py:25``) and the model's decode
path's (``models/transformer/attention.py:_decode_local``), taken over the
whole cache at once. At ``cur_len = 0`` it gives zeros, as both of them
do; the reference's ``ref.py`` runs a softmax over a row that is all
``NEG_INF`` there and returns the mean of every value row (ROADMAP C5).

``cur_len`` may be a Python int or an int tensor on the cache's device;
read there, it costs the host no wait. The CPU path and the tests use this
version; on the card ``ops.py`` runs the CUDA kernel
(``csrc/flash_decode.cu``), which sums in another order (split over the
KV axis, then merged): the two agree within float32 rounding.
``flash_decode_split_ref`` takes the kernel's split and merge in plain
PyTorch, for the CPU tests of that order of work.
"""
from __future__ import annotations

import torch

from ..common import NEG_INF


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len) -> torch.Tensor:
    """q [B, kh, g, dh]; caches [B, S, kh, dh] -> float32 [B, kh, g, dh]."""
    dh = q.shape[-1]
    s = k_cache.shape[1]
    qs = q.float() * dh ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qs, k_cache.float())
    live = torch.arange(s, device=k_cache.device) < torch.as_tensor(
        cur_len, device=k_cache.device)
    scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = torch.clamp(scores.amax(-1, keepdim=True), min=NEG_INF)
    p = torch.exp(scores - m) * live
    l = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o / torch.clamp(l, min=1e-30)[..., None]


def flash_decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_len, split: int,
                           nsplit: int) -> torch.Tensor:
    """The CUDA kernel's order of work in plain PyTorch: the cache cut into
    ``nsplit`` splits of ``split`` positions (``nsplit * split >= S``), each
    keeping its own ``(m, l, acc)`` over its live positions (pass 1), then
    the live splits merged: ``M = max m``, ``L = sum l e^(m - M)``, ``A =
    sum acc e^(m - M)``, ``A / max(L, 1e-30)`` (pass 2). Splits that start
    at or past the length are dead and left out, so at ``cur_len = 0`` the
    output is zeros. q [B, kh, g, dh]; caches [B, S, kh, dh] -> float32
    [B, kh, g, dh]."""
    b, kh, g, dh = q.shape
    s = k_cache.shape[1]
    if nsplit * split < s:
        raise ValueError(f"{nsplit} splits of {split} do not cover S={s}")
    pad = nsplit * split - s
    dev = k_cache.device
    k = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    k = k.reshape(b, nsplit, split, kh, dh)
    v = v.reshape(b, nsplit, split, kh, dh)
    length = torch.clamp(torch.as_tensor(cur_len, device=dev), 0, s)
    pos = torch.arange(nsplit * split, device=dev).reshape(nsplit, split)
    live = pos < length                                   # [nsplit, split]
    qs = q.float() * dh ** -0.5
    scores = torch.einsum("bkgd,bntkd->bkgnt", qs, k)
    scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = torch.clamp(scores.amax(-1), min=NEG_INF)         # [b, kh, g, n]
    p = torch.exp(scores - m[..., None]) * live
    l = p.sum(-1)
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p, v)
    split_live = pos[:, 0] < length                       # [nsplit]
    mx = torch.clamp(torch.where(split_live, m, torch.full_like(m, NEG_INF))
                     .amax(-1, keepdim=True), min=NEG_INF)
    w = torch.exp(m - mx) * split_live
    lsum = (l * w).sum(-1)
    asum = (acc * w[..., None]).sum(-2)
    return asum / torch.clamp(lsum, min=1e-30)[..., None]
