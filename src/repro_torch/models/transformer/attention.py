"""Attention on one device: RoPE, blockwise causal attention, decode.

The reference's ``models/transformer/attention.py`` without its mesh
schemes (head-TP, context-parallel, the sequence-sharded decode cache):
one card holds every head and the whole cache.

Flat head index convention, as the reference's: ``h = k_idx * g + g_idx``
(kh-major), which ``repeat_interleave(g)`` of the KV heads produces and the
decode path's ``(kh, g)`` reshape matches. Softmax statistics are float32.

``flash_attention`` is plain PyTorch, blockwise over ``kv_chunk`` as the
reference's scan (XLA there, no Pallas kernel). ``decode_attention``
writes the new token into the cache, then runs the hand-written
``flash_decode`` kernel over positions ``< cur_len + 1``; the reference
attends over the cache first and merges the new token in after
(``_decode_local`` + ``_merge_with_new_token``). The two are the same
softmax, summed in another order.
"""
from __future__ import annotations

import torch

from ...kernels.common import NEG_INF
from ...kernels.flash_decode import flash_decode


def rope_frequencies(d_head: int, theta: float,
                     device: str | torch.device) -> torch.Tensor:
    """``theta ** (-i / half)`` for ``i < d_head / 2``, float32, made on
    ``device`` (theta goes to the kernel as a scalar: no host-to-device
    copy, which would wait for the card)."""
    half = d_head // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, d_head]; positions: int tensor broadcastable to
    [..., S] (on x's device: a decode step passes its device-side length,
    and nothing waits on the host)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # [half]
    angles = positions[..., None].float() * freqs            # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset=0,
                    kv_chunk: int = 256) -> torch.Tensor:
    """q [B, S, H, dh], k / v [B, T, K, dh] -> [B, S, H, dh] in q's dtype:
    an online softmax over KV chunks of ``kv_chunk`` positions, the
    reference's scan as a loop. Scores and statistics are float32 (the
    reference's ``preferred_element_type``)."""
    b, s, h, dh = q.shape
    _, t, kh, _ = k.shape
    g = h // kh
    assert g * kh == h, (h, kh)
    scale = dh ** -0.5
    if g > 1:  # broadcast KV heads to the kh-major full head count
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qs = (q * scale).float()
    dev = q.device
    ck = min(kv_chunk, t)
    q_pos = torch.arange(s, device=dev) + q_offset
    m = torch.full((b, s, h), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=dev)
    o = torch.zeros((b, s, h, dh), dtype=torch.float32, device=dev)
    for c0 in range(0, t, ck):
        kc = k[:, c0:c0 + ck].float()
        vc = v[:, c0:c0 + ck].float()
        sblk = torch.einsum("bshd,bchd->bshc", qs, kc)
        kv_pos = c0 + torch.arange(kc.shape[1], device=dev)
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]             # [S, c]
            sblk = torch.where(mask[None, :, None, :], sblk,
                               torch.full_like(sblk, NEG_INF))
        m_new = torch.maximum(m, sblk.amax(-1))
        p = torch.exp(sblk - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bshc,bchd->bshd", p, vc)
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cur_len
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, H, dh] (kh-major heads), caches [B, Smax, K, dh], the new
    token's k_new / v_new [B, K, dh], ``cur_len`` the tokens already cached
    (an int tensor on the cache's device). Writes the new token's K and V
    at ``cur_len`` **in place** (the cache needs ``Smax > cur_len``), then
    attends over positions ``< cur_len + 1``. Returns (out [B, H, dh] in
    q's dtype, k_cache, v_cache)."""
    b, h, dh = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, dh)  # kh-major, matching repeat_interleave
    cur = torch.as_tensor(cur_len, device=k_cache.device)
    pos = cur.reshape(1).long()
    k_cache.index_copy_(1, pos, k_new[:, None].to(k_cache.dtype))
    v_cache.index_copy_(1, pos, v_new[:, None].to(v_cache.dtype))
    o = flash_decode(qg, k_cache, v_cache, cur + 1)
    return o.reshape(b, h, dh).to(q.dtype), k_cache, v_cache
