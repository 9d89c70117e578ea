"""Plain PyTorch version of the fused L2 scan + top-k.

:func:`l2_topk_scan_ref` is the kernel's own function, term for term:
scores ``2 q.d - d_sq`` and the k best of those pairs plus k pads
``(NEG_INF, PAD_ID)``, under the total order (score descending, id
ascending). ``torch.topk`` does not promise the lower id on ties, so the
selection is a stable descending sort with the pads placed first.

:func:`prepare` and :func:`finish` are the op's metric, mask and score
rules around the scan (the reference's ``kernels/l2_topk/ops.py``); both
the CUDA and the plain path run them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import NEG_INF, PAD_ID, PAD_PENALTY


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
