"""Exact vector search on one device: the Flat scan.

On a CUDA tensor the scan and the top-k run in the hand-written
``l2_topk`` kernel (``kernels/l2_topk``). On a CPU tensor they run as the
plain PyTorch mirror of the reference's single-device branch
(``src/repro/search/distributed.py:141-149``): the same score form, and a
top-k that breaks ties to the lower id. The reference's mesh branch
(corpus row-sharded over several devices, merged by ``topk_merge``) needs
more than one device and is not ported; on one card the sharded tier is
``api/sharded.py``'s thread pool.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..kernels.common import NEG_INF, PAD_ID
from ..kernels.l2_topk import l2_topk


def _padded_topk(s: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis under (score desc, index asc), clamped to
    the axis size and padded back to ``k`` with ``(NEG_INF, PAD_ID)`` when
    k overflows it. Indices are int32."""
    n = s.shape[-1]
    kl = min(k, n)
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    i = order[..., :kl]
    v = torch.gather(s, -1, i)
    i = i.to(torch.int32)
    if kl < k:
        pad = (*v.shape[:-1], k - kl)
        v = torch.cat([v, torch.full(pad, NEG_INF, dtype=v.dtype,
                                     device=v.device)], -1)
        i = torch.cat([i, torch.full(pad, PAD_ID, dtype=i.dtype,
                                     device=i.device)], -1)
    return v, i


def distributed_topk(scores_: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores [N] (higher = better) -> (vals [k], ids [k] int32): the
    reference's single-device branch (``_padded_topk``), ties to the lower
    id, ``k > N`` padded with ``(NEG_INF, PAD_ID)``. Its mesh branch (rows
    sharded over several devices, merged by ``topk_merge``) waits for a
    4-chip cell, as ``search``'s does."""
    return _padded_topk(scores_, k)


def scores(queries: torch.Tensor, db: torch.Tensor, metric: str
           ) -> torch.Tensor:
    """[Q, N] similarity scores (higher = closer), the reference's form."""
    q32 = queries.float()
    d32 = db.float()
    if metric == "cosine":
        qn = q32 / torch.clamp(torch.linalg.norm(q32, dim=-1, keepdim=True),
                               min=1e-12)
        dn = d32 / torch.clamp(torch.linalg.norm(d32, dim=-1, keepdim=True),
                               min=1e-12)
        return qn @ dn.T
    if metric == "euclidean":
        q2 = torch.sum(q32 * q32, -1)[:, None]
        d2 = torch.sum(d32 * d32, -1)[None, :]
        return -(q2 - 2.0 * q32 @ d32.T + d2)  # negative squared distance
    raise ValueError(metric)


def search(queries: torch.Tensor, db: torch.Tensor, k: int,
           metric: str = "euclidean", alive: Optional[torch.Tensor] = None,
           mesh: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: returns (scores [Q, k], indices [Q, k] int32).

    ``alive`` (bool [N]) tombstones db rows: a dead row never surfaces, its
    slot pads to ``(NEG_INF, PAD_ID)`` (the ``l2_topk`` ``db_mask``
    contract). ``k > N`` pads the tail the same way."""
    if mesh is not None:
        raise NotImplementedError(
            "search over a device mesh (corpus row-sharded over several "
            "devices, merged by topk_merge) is not ported: it needs more "
            "than one device and waits for a 4-chip cell; on one card use "
            "the Shard<S> stage (api/sharded.py, thread pool)")
    if queries.device.type == "cuda":
        return l2_topk(queries, db, k, metric, db_mask=alive)
    s = scores(queries, db, metric)
    if alive is None:
        return _padded_topk(s, k)
    s = torch.where(alive[None, :].to(torch.bool), s,
                    torch.full_like(s, NEG_INF))
    v, i = _padded_topk(s, k)
    i = torch.where(v <= NEG_INF / 2, torch.full_like(i, PAD_ID), i)
    return torch.where(i == PAD_ID, torch.full_like(v, NEG_INF), v), i
