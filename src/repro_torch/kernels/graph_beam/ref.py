"""Plain PyTorch version of the fused gather + L2 + beam-merge hop.

One HNSW traversal hop, term for term the reference's
``kernels/graph_beam/ref.py``: gather the ``nbr_ids`` rows, score
``2 q.v - |v|^2 - |q|^2``, set masked slots (id < 0, or a ``db_mask``
tombstone) to ``NEG_INF``, and merge into the ``[Q, ef]`` beam by a stable
descending sort over ``[beam, candidates]``: ties go to the beam entry
first, then to the lower candidate slot (not ``l2_topk``'s lower-id rule).
Pads come out as ``(NEG_INF, PAD_ID)``.

The dot products and norms are summed by :func:`pairwise_sum`, a fixed
balanced tree of elementwise adds. Its order depends on the row width
only, so a row's answer does not depend on its batch-mates, and the CUDA
kernel (``csrc/graph_beam.cu``) sums in the same tree: kernel and plain
version agree bit for bit on any float32 input.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import NEG_INF, canonicalize_pads


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a balanced pairwise tree: adjacent pairs
    first, then adjacent pair sums, and so on, with a zero appended to a
    level of odd width (the same tree as zero-padding the axis to a power
    of two). Elementwise ops only, so the order never depends on the other
    axes' sizes, as a library reduction's may."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def graph_beam_ref(queries: torch.Tensor, db: torch.Tensor,
                   nbr_ids: torch.Tensor, beam_v: torch.Tensor,
                   beam_i: torch.Tensor,
                   db_sq: Optional[torch.Tensor] = None,
                   q_sq: Optional[torch.Tensor] = None,
                   db_mask: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, d]; db [N, d]; nbr_ids [Q, W] int (-1 = masked slot);
    beam_v/beam_i [Q, ef], sorted descending, empty slots ``(NEG_INF, -1)``
    or ``(-inf, -1)``. ``db_sq`` [N] / ``q_sq`` [Q]: squared norms,
    recomputed when absent. ``db_mask`` (bool [N]) tombstones rows: a
    masked candidate is a -1 slot. Returns the merged (vals [Q, ef]
    float32, ids [Q, ef] int32), sorted descending."""
    q = queries.float()
    d = db.float()
    ids = nbr_ids.to(torch.int32)
    bv = beam_v.float()
    bi = beam_i.to(torch.int32)
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    if db_mask is not None:
        valid = valid & db_mask.to(torch.bool)[safe]
    if db_sq is None:
        db_sq = pairwise_sum(d * d)
    if q_sq is None:
        q_sq = pairwise_sum(q * q)
    g = d[safe]                                              # [Q, W, d]
    s = 2.0 * pairwise_sum(g * q[:, None, :])
    s = s - db_sq.float()[safe]
    s = s - q_sq.float()[:, None]
    return merge_into_beam(bv, bi, s, ids, valid)


def merge_into_beam(bv: torch.Tensor, bi: torch.Tensor, s: torch.Tensor,
                    ids: torch.Tensor, valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate scores ``s`` [Q, W] (ids [Q, W]; slots not
    ``valid`` become ``(NEG_INF, -1)``) into the beam ``(bv, bi)`` [Q, ef]:
    the first ef entries of a stable descending sort of [beam, candidates],
    pads canonicalized. Shared by the f32 and the quantized hops."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    allv = torch.cat([bv, s], dim=1)
    alli = torch.cat([bi, torch.where(valid, ids, torch.full_like(ids, -1))],
                     dim=1)
    order = torch.sort(allv, dim=1, descending=True,
                       stable=True).indices[:, :bv.shape[1]]
    return canonicalize_pads(torch.gather(allv, 1, order),
                             torch.gather(alli, 1, order))
