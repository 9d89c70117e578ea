"""Public traversal-hop op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import graph_beam_cuda
from .ref import graph_beam_ref, pairwise_sum


def graph_beam(queries: torch.Tensor, db: torch.Tensor,
               nbr_ids: torch.Tensor, beam_v: torch.Tensor,
               beam_i: torch.Tensor, db_sq: Optional[torch.Tensor] = None,
               q_sq: Optional[torch.Tensor] = None,
               db_mask: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused traversal hop: gather the ``nbr_ids`` rows of ``db``,
    score them against ``queries`` (``-|q - v|^2``) and merge them into
    the running ``(beam_v, beam_i)`` top-ef beam. Shapes and rules are
    those of :func:`.ref.graph_beam_ref` and of the reference's op
    (``kernels/graph_beam/ops.py``); ``db_mask`` tombstones are demoted to
    -1 ids before the kernel, which takes no mask of its own."""
    if queries.device.type == "cpu":
        return graph_beam_ref(queries, db, nbr_ids, beam_v, beam_i, db_sq,
                              q_sq, db_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"graph_beam: no implementation for device "
                         f"{queries.device}")
    ids = nbr_ids.to(torch.int32)
    if db_mask is not None:
        safe = torch.where(ids >= 0, ids, torch.zeros_like(ids)).long()
        ids = torch.where((ids >= 0) & db_mask.to(torch.bool)[safe], ids,
                          torch.full_like(ids, -1))
    q = queries.float().contiguous()
    d = db.float().contiguous()
    if db_sq is None:
        db_sq = pairwise_sum(d * d)
    if q_sq is None:
        q_sq = pairwise_sum(q * q)
    return graph_beam_cuda(q, d, db_sq.float().contiguous(),
                           q_sq.float().contiguous(), ids.contiguous(),
                           beam_v.float().contiguous(),
                           beam_i.to(torch.int32).contiguous())
