"""Public fused scan + top-k op: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import l2_topk_scan_cuda
from .ref import finish, l2_topk_ref, prepare


def l2_topk(queries: torch.Tensor, db: torch.Tensor, k: int,
            metric: str = "euclidean",
            db_mask: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused exact top-k scan. Returns (scores [Q, k], indices [Q, k]
    int32); scores are similarities (euclidean -> -|q-d|^2, cosine -> cos
    sim). ``db_mask`` (bool [N]) tombstones db rows: a masked row never
    appears in the output, its slot canonicalizes to ``(NEG_INF,
    PAD_ID)``. ``k > N`` pads the tail with ``PAD_ID`` ids. The rules are
    those of the reference's Pallas op (``kernels/l2_topk/ops.py``)."""
    if queries.device.type == "cpu":
        return l2_topk_ref(queries, db, k, metric, db_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"l2_topk: no implementation for device "
                         f"{queries.device}")
    q, d, d_sq = prepare(queries, db, metric, db_mask)
    vals, ids = l2_topk_scan_cuda(q, d, d_sq, k)
    return finish(vals, ids, q, metric, db_mask is not None)
