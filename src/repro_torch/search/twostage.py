"""Stage 2 of two-stage retrieval: the exact full-space rerank.

Stage 1 scans the reduced corpus for k * rerank_factor candidates; this
module re-scores only those candidates in the original space. Plain
PyTorch on every device: the reference has no TPU kernel here either.
"""
from __future__ import annotations

import torch


def rerank_candidates(queries: torch.Tensor, db_full: torch.Tensor,
                      cand: torch.Tensor, k: int,
                      metric: str = "euclidean"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact full-space rerank of a padded candidate matrix.

    ``queries`` [Q, n], ``db_full`` [N, n], ``cand`` [Q, k1] int (id -1 =
    pad from a short stage-1 row). Returns (scores [Q, k], indices [Q, k])
    — higher = closer. Pads keep their -1 id but score -inf, so they can
    never outrank a real candidate. Ties go to the earlier candidate.
    """
    # an id of -1 gathers the LAST corpus row (negative indices wrap, as in
    # the reference's jnp.take) and is pinned to -inf below
    cand_vecs = db_full[cand.long()]  # [Q, k1, n]
    q32 = queries.float()
    c32 = cand_vecs.float()
    if metric == "cosine":
        qn = q32 / torch.clamp(torch.linalg.norm(q32, dim=-1, keepdim=True),
                               min=1e-12)
        cn = c32 / torch.clamp(torch.linalg.norm(c32, dim=-1, keepdim=True),
                               min=1e-12)
        s = torch.einsum("qd,qcd->qc", qn, cn)
    else:
        s = -torch.sum(torch.square(c32 - q32[:, None, :]), -1)
    s = torch.where(cand >= 0, s, torch.full_like(s, float("-inf")))
    sel = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, sel), torch.gather(cand, 1, sel)
