"""Plain PyTorch version of the fused L2 scan + top-k.

:func:`l2_topk_scan_ref` is the kernel's own function, term for term:
scores ``2 q.d - d_sq`` and the k best of those pairs plus k pads
``(NEG_INF, PAD_ID)``, under the total order (score descending, id
ascending). ``torch.topk`` does not promise the lower id on ties, so the
selection is a stable descending sort with the pads placed first.

:func:`prepare` and :func:`finish` are the op's metric, mask and score
rules around the scan (the reference's ``kernels/l2_topk/ops.py``); both
the CUDA and the plain path run them.

:func:`l2_topk_select_ref` is a model of the card kernel's selection
(``csrc/l2_topk.cu`` on ``csrc/topk_select.cuh``), held against
:func:`l2_topk_scan_ref` on the CPU: per (query, chunk of rows) a running
threshold, a survivor list cut back to k by the kernel's radix select when
it would overflow, and a second pass that selects k from the chunks' lists
with the same select and sorts them (:func:`select_lists_ref`, which the
``pq_adc`` model runs too).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import NEG_INF, PAD_ID, PAD_PENALTY

#: Rows a warp of the kernel offers a survivor list at once (one a lane).
GROUP = 32


def l2_topk_scan_ref(q: torch.Tensor, d: torch.Tensor, d_sq: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q [Q, dim], d [N, dim], d_sq [N] -> (vals [Q, k] f32, ids [Q, k] i32)."""
    s = 2.0 * (q @ d.T) - d_sq[None, :]
    pads = torch.full((s.shape[0], k), NEG_INF, dtype=s.dtype,
                      device=s.device)
    allv = torch.cat([pads, s], dim=1)  # column c >= k is row c - k
    order = torch.sort(allv, dim=1, descending=True, stable=True).indices
    order = order[:, :k]
    vals = torch.gather(allv, 1, order)
    ids = torch.where(order < k, PAD_ID, order - k).to(torch.int32)
    return vals, ids


def order_keys(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of the pairs (score descending, id
    ascending): the kernel's unsigned 64-bit key, the order-preserving bits
    of the score (-0 read as +0) above ``0x7fffffff - id``, less 2**63 so
    that signed order is its order. Distinct pairs have distinct keys."""
    v = torch.where(vals == 0, torch.zeros_like(vals), vals).float()
    b = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordv = torch.where(b >= 2 ** 31, ~b & 0xFFFFFFFF, b | 2 ** 31)
    lo = (0x7FFFFFFF - ids.to(torch.int64)) & 0xFFFFFFFF
    return ((ordv - 2 ** 31) << 32) | lo


def radix_select(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, int]:
    """The kernel's select of the k largest of ``keys`` (distinct int64
    keys, more than k): one histogram of 256 bins a pass over the next 8
    bits of the keys that match the digits chosen so far, from the top; it
    stops at the first pass whose chosen bin holds exactly the pairs still
    needed (at the last pass at worst, where a bin holds one key). Returns
    (mask of the k kept keys, the k-th largest key)."""
    need, prefix = k, 0
    for level in range(1, 9):
        shift = 64 - 8 * level
        top = keys >> shift
        if level == 1:
            digit = top + 128
        else:
            digit = top & 255
            digit = digit[(top >> 8) == prefix]
        hist = torch.bincount(digit, minlength=256)
        at_or_above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
        d = int(torch.nonzero(at_or_above >= need).max())
        need -= int(at_or_above[d] - hist[d])
        prefix = d - 128 if level == 1 else (prefix << 8) | d
        if int(hist[d]) == need:
            break
    keep = (keys >> shift) >= prefix
    return keep, int(keys[keep].min())


def l2_topk_select_ref(q: torch.Tensor, d: torch.Tensor, d_sq: torch.Tensor,
                       k: int, chunk: int, cap: int,
                       tile_cut: Optional[int] = None, tile: int = 256,
                       row_step: int = 1,
                       seed: Optional[tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The card kernel's algorithm on the plain version's scores, one
    query at a time: pass 1 walks each chunk of ``chunk`` rows in tiles of
    ``tile`` rows and groups of ``GROUP`` rows and appends the pairs that
    beat the list's threshold (at first the pad pair: a real pair must beat
    ``(NEG_INF, PAD_ID)``). A cut (:func:`radix_select`) keeps a list's k
    best and raises the threshold to the k-th. With ``tile_cut`` None (the
    lists in shared memory) a group that would take the list past ``cap``
    pairs first cuts it; otherwise (the lists in device memory, ``cap >=
    tile_cut + tile``) a list holding more than ``tile_cut`` pairs after a
    tile is cut. At the chunk's end a list of more than k pairs is cut to
    k. Pass 2 cuts the chunks' lists together to k and sorts them; fewer
    than k real pairs leave the tail to pads. Same arguments and result as
    :func:`l2_topk_scan_ref`, over the rows ``0, row_step, 2 row_step,
    ...`` (a pilot's sample). ``seed`` (a pilot's [Q, k] result): each
    list's first threshold is the seed's k-th pair (v0, i0) as (v0, i0 +
    1), which that pair itself passes."""
    if (cap < k + GROUP if tile_cut is None
            else tile_cut < k + GROUP or cap < tile_cut + tile):
        raise ValueError(f"k={k}, cap={cap}, tile_cut={tile_cut}")
    s = (2.0 * (q @ d.T) - d_sq[None, :])[:, ::row_step]
    nq = s.shape[0]
    first = (torch.full((nq,), NEG_INF), torch.full((nq,), PAD_ID))
    if seed is not None:
        first = (seed[0][:, -1], seed[1][:, -1] + 1)
    return select_lists_ref(s, row_step, k, chunk, cap, tile_cut, tile, first)


def select_lists_ref(s: torch.Tensor, row_step: int, k: int, chunk: int,
                     cap: int, tile_cut: Optional[int], tile: int,
                     first: tuple[torch.Tensor, torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The card's survivor-list selection (``csrc/topk_select.cuh``, as
    ``l2_topk.cu`` and ``pq_adc.cu`` run it) over the scores ``s`` [Q, n]
    of the scan rows ``0, row_step, 2 row_step, ...``, one query at a time:
    each chunk of ``chunk`` rows keeps a list, walked in tiles of ``tile``
    rows and groups of ``GROUP`` rows, that appends the pairs beating its
    threshold (at first ``first`` [Q] (values, ids): a pair must beat it).
    A cut (:func:`radix_select`) keeps a list's k best and raises the
    threshold to the k-th. With ``tile_cut`` None a group that would take
    the list past ``cap`` pairs first cuts it; otherwise a list holding
    more than ``tile_cut`` pairs after a tile is cut. At the chunk's end a
    list of more than k pairs is cut to k. The merge pass cuts the chunks'
    lists together to k and sorts them; fewer than k real pairs leave the
    tail to pads ``(NEG_INF, PAD_ID)``."""
    nq, n = s.shape
    rows = torch.arange(n, dtype=torch.int32) * row_step
    first = order_keys(first[0].float(), first[1])
    vals = torch.full((nq, k), NEG_INF, dtype=s.dtype)
    ids = torch.full((nq, k), PAD_ID, dtype=torch.int32)
    for qi in range(nq):
        keys_q = order_keys(s[qi], rows)
        kept = []
        for c0 in range(0, n, chunk):
            c1 = min(n, c0 + chunk)
            thr = int(first[qi])
            lst = torch.zeros(0, dtype=torch.int64)      # row ids
            for t0 in range(c0, c1, tile):
                for g0 in range(t0, min(c1, t0 + tile), GROUP):
                    g = torch.arange(g0, min(c1, g0 + GROUP))
                    take = keys_q[g] > thr
                    if (tile_cut is None
                            and lst.numel() + int(take.sum()) > cap):
                        keep, thr = radix_select(keys_q[lst], k)
                        lst = lst[keep]
                        take = keys_q[g] > thr
                    lst = torch.cat([lst, g[take]])
                if tile_cut is not None and lst.numel() > tile_cut:
                    keep, thr = radix_select(keys_q[lst], k)
                    lst = lst[keep]
            if lst.numel() > k:
                lst = lst[radix_select(keys_q[lst], k)[0]]
            kept.append(lst)
        cand = torch.cat(kept)
        if cand.numel() > k:
            cand = cand[radix_select(keys_q[cand], k)[0]]
        cand = cand[torch.argsort(keys_q[cand], descending=True)]
        vals[qi, :cand.numel()] = s[qi, cand]
        ids[qi, :cand.numel()] = rows[cand]
    return vals, ids


def prepare(queries: torch.Tensor, db: torch.Tensor, metric: str,
            db_mask: Optional[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 queries and corpus (unit rows for cosine) and the corpus
    row term ``d_sq``: ``|d|^2``, or ``PAD_PENALTY`` on tombstoned rows so
    they ride the never-wins lane."""
    q = queries.float()
    d = db.float()
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                            min=1e-12)
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                            min=1e-12)
    elif metric != "euclidean":
        raise ValueError(metric)
    d_sq = torch.sum(d * d, dim=-1)
    if db_mask is not None:
        d_sq = torch.where(db_mask.to(torch.bool), d_sq,
                           torch.full_like(d_sq, PAD_PENALTY))
    return q.contiguous(), d.contiguous(), d_sq.contiguous()


def finish(vals: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
           metric: str, masked: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan pairs -> similarities: ``-|q - d|^2`` (euclidean) or the cosine
    ``(v + 1) / 2``; with a mask, slots the penalty lane produced become
    ``(NEG_INF, PAD_ID)``."""
    if metric == "euclidean":
        vals = vals - torch.sum(q * q, dim=-1, keepdim=True)
    else:
        # the scan computed 2 q.d - |d|^2 with |d| = 1 -> cos = (v + 1) / 2
        vals = (vals + 1.0) / 2.0
    if masked:
        dead = vals <= NEG_INF / 2
        vals = torch.where(dead, torch.full_like(vals, NEG_INF), vals)
        ids = torch.where(dead, torch.full_like(ids, PAD_ID), ids)
    return vals, ids


def l2_topk_ref(queries: torch.Tensor, db: torch.Tensor, k: int,
                metric: str = "euclidean",
                db_mask: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole op on plain PyTorch (see :func:`..ops.l2_topk`)."""
    q, d, d_sq = prepare(queries, db, metric, db_mask)
    vals, ids = l2_topk_scan_ref(q, d, d_sq, k)
    return finish(vals, ids, q, metric, db_mask is not None)
