"""k-NN preservation metrics (paper Section 3.1, Definitions 1-2).

P_overall (Eq. 4) = (1/kN) sum_a |N_k^X(a) ∩ N_k^X'(a)|: the fraction of
original k-nearest neighbors retained after dimensionality reduction.

Plain PyTorch: exact ground truth for the port's checks, not a search path.
Ties in a top-k go to the lower index, as ``lax.top_k`` in the reference
does (``torch.topk`` does not promise it), through a stable sort.
"""
from __future__ import annotations

from typing import Optional

import torch


def pairwise_distances(q: torch.Tensor, db: torch.Tensor,
                       metric: str = "euclidean") -> torch.Tensor:
    """[Q, N] distance matrix (smaller = closer)."""
    q = q.float()
    db = db.float()
    if metric == "cosine":
        qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                             min=1e-12)
        dn = db / torch.clamp(torch.linalg.norm(db, dim=-1, keepdim=True),
                              min=1e-12)
        return 1.0 - qn @ dn.T
    if metric == "euclidean":
        q2 = torch.sum(q * q, -1)[:, None]
        d2 = torch.sum(db * db, -1)[None, :]
        sq = torch.clamp(q2 - 2.0 * q @ db.T + d2, min=0.0)
        return torch.sqrt(sq)
    raise ValueError(f"unknown metric {metric!r}")


def knn_indices(q: torch.Tensor, db: torch.Tensor, k: int,
                metric: str = "euclidean", exclude_self: bool = False,
                chunk: int = 256) -> torch.Tensor:
    """Indices [Q, k] (int64) of the k nearest db rows for each query row,
    chunked over queries. ``exclude_self`` masks the diagonal (q and db are
    the same collection)."""
    out = []
    for s in range(0, q.shape[0], chunk):
        d = pairwise_distances(q[s:s + chunk], db, metric)
        if exclude_self:
            rows = torch.arange(s, s + d.shape[0], device=d.device)
            d[rows - s, rows] = float("inf")
        out.append(torch.sort(d, dim=1, stable=True).indices[:, :k])
    return torch.cat(out)


def set_overlap(idx_a: torch.Tensor, idx_b: torch.Tensor) -> torch.Tensor:
    """Mean |A_i ∩ B_i| / k for two [N, k] index matrices."""
    inter = (idx_a[:, :, None] == idx_b[:, None, :]).any(-1)
    return torch.mean(inter.float())


def recall_at_k(pred_idx: torch.Tensor, true_idx: torch.Tensor) -> float:
    """Retrieval recall: fraction of true top-k found in predicted top-k."""
    return float(set_overlap(torch.as_tensor(true_idx),
                             torch.as_tensor(pred_idx)))


def preservation_accuracy(x_orig, x_red, k: int = 5,
                          metric: str = "euclidean",
                          metric_reduced: Optional[str] = None,
                          chunk: int = 256) -> float:
    """P_overall (Eq. 4): mean fraction of original k-NN retained in the
    reduced space. The same collection serves as anchors and database,
    self excluded (the paper's protocol). Runs on ``x_orig``'s device
    (numpy inputs: the CPU), chunked over anchors."""
    x_orig = torch.as_tensor(x_orig)
    x_red = torch.as_tensor(x_red, device=x_orig.device)
    mr = metric_reduced or metric
    idx_o = knn_indices(x_orig, x_orig, k, metric, exclude_self=True,
                        chunk=chunk)
    idx_r = knn_indices(x_red, x_red, k, mr, exclude_self=True, chunk=chunk)
    return float(set_overlap(idx_o, idx_r))
