"""IVF (inverted-file) coarse quantization: the reference's ``search/ivf.py``.

k-means coarse centroids partition the corpus; a query probes its
``nprobe`` nearest cells and scans only their lists. The ragged inverted
lists are a padded dense layout (``[n_cells, cap, d]`` + validity mask), so
the probe scan is a fixed-shape gather + batched product, in PyTorch ops on
the index's device: the reference runs it in XLA, outside any Pallas
kernel.

Differences from the reference, each kept out of the answers:

* ``kmeans`` draws its initial rows from ``numpy.random.default_rng(seed)``:
  torch cannot reproduce ``jax.random.choice``. ``init=`` takes the rows
  explicitly (the parity tests pass the reference's draw).
* The Lloyd update sums each cell as a one-hot product over row chunks, a
  fixed order on every device: a float scatter-add on the card sums in
  atomic order, and two builds from one seed would differ in the last bits.
* The probe scan runs in query chunks whose gathered slab stays within
  :data:`SLAB_BYTES` (at 1M rows, IVF256, nprobe 16 a 256-query batch would
  gather 10 GB). Rows are independent, so the answers do not change.
* The list vectors' squared norms are computed once per list (``list_sq``)
  instead of on every gathered slab.

Tie orders: the probed cells are the stable descending order of ``-d2c``
(ties to the lower cell, as ``lax.top_k``). The candidates are ranked by
(score descending, corpus id ascending) over the flattened ``[P * cap]``
slab (:func:`topk_by_score_then_id`), the North Star contract. The
reference ranks equal scores by slab position (probe rank, then slot), so
a re-laid list renames tied ids; the port does not copy that
(``ROADMAP.md`` C8). Scores are the reference's; only tied ids differ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

#: Most bytes of gathered list vectors one probe-scan chunk may hold.
SLAB_BYTES = 2 << 30

#: Rows per one-hot product of the Lloyd update.
_SUM_CHUNK = 65536


@dataclass
class IVFIndex:
    centroids: torch.Tensor   # [C, d]
    lists: torch.Tensor       # [C, cap] int32 corpus row ids (-1 = pad)
    list_vecs: torch.Tensor   # [C, cap, d] padded member vectors
    list_mask: torch.Tensor   # [C, cap] bool
    spill: int                # rows dropped by the cap (0 in healthy builds)
    list_sq: Optional[torch.Tensor] = None  # [C, cap] |v|^2, derived

    def __post_init__(self):
        if self.list_sq is None:
            self.list_sq = torch.sum(self.list_vecs * self.list_vecs, -1)


def topk_by_score_then_id(s: torch.Tensor, ids: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best entries of each row of ``s`` ``[q, L]`` (float32) under
    (score descending, id ascending), with their ids from ``ids`` ``[q, L]``
    (int, -1 allowed): one ``int64`` key a slot, the score's bits mapped to
    an order-preserving integer in the high 32 bits (``-0.0`` as ``+0.0``)
    and ``2^31 - 1 - id`` in the low 32, selected in one ``topk``. Slots
    with equal keys hold equal (score, id) pairs, so the answer is
    unique."""
    bits = (s.float() + 0.0).contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = (ordered.to(torch.int64) << 32) | (0x7FFFFFFF
                                             - ids.to(torch.int64))
    top = torch.topk(key, k, dim=1).indices
    return torch.gather(s, 1, top), torch.gather(ids, 1, top)


def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[n, C] squared distances, the reference's expansion."""
    return (torch.sum(x * x, 1)[:, None] - 2 * x @ cent.T
            + torch.sum(cent * cent, 1)[None, :])


def _cell_sums(x: torch.Tensor, assign: torch.Tensor, n_clusters: int
               ) -> torch.Tensor:
    """[C, d] sum of each cell's rows, in a fixed order on any device."""
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                       device=x.device)
    for s in range(0, x.shape[0], _SUM_CHUNK):
        a = assign[s:s + _SUM_CHUNK]
        onehot = torch.zeros((a.shape[0], n_clusters), dtype=x.dtype,
                             device=x.device)
        onehot[torch.arange(a.shape[0], device=x.device), a] = 1.0
        sums += onehot.T @ x[s:s + _SUM_CHUNK]
    return sums


def init_rows(n: int, n_clusters: int, seed: int) -> np.ndarray:
    """The port's k-means init: ``n_clusters`` distinct rows of ``n``."""
    return np.random.default_rng(seed).choice(n, n_clusters, replace=False)


def kmeans(x: torch.Tensor, n_clusters: int, iters: int = 10, seed: int = 0,
           init: Optional[np.ndarray] = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Lloyd's k-means from ``n_clusters`` distinct rows (``init``,
    or :func:`init_rows` of ``seed``). Returns (centroids [C, d], the last
    step's assignment [n] int64), as the reference's."""
    n = x.shape[0]
    idx = init_rows(n, n_clusters, seed) if init is None else np.array(init)
    cent = x[torch.as_tensor(idx, dtype=torch.long, device=x.device)]
    assign = None
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(x, cent), 1)
        sums = _cell_sums(x, assign, n_clusters)
        cnt = torch.bincount(assign, minlength=n_clusters).to(x.dtype)
        new = sums / torch.clamp(cnt, min=1.0)[:, None]
        # keep empty clusters where they were
        cent = torch.where(cnt[:, None] > 0, new, cent)
    return cent, assign


def build(corpus: torch.Tensor, n_cells: int, cell_cap: Optional[int] = None,
          kmeans_iters: int = 10, seed: int = 0,
          init: Optional[np.ndarray] = None) -> IVFIndex:
    corpus = corpus.float()
    n, d = corpus.shape
    dev = corpus.device
    cent, assign = kmeans(corpus, n_cells, kmeans_iters, seed, init)
    cap = cell_cap or int(np.ceil(2.5 * n / n_cells))
    # the reference's vectorized list fill: stable-sort rows by cell, so
    # each row's slot is its rank within its cell
    order = torch.sort(assign, stable=True).indices
    sorted_cells = assign[order]
    starts = torch.searchsorted(sorted_cells,
                                torch.arange(n_cells, device=dev),
                                side="left")
    pos = torch.arange(n, device=dev) - starts[sorted_cells]
    keep = pos < cap
    lists = torch.full((n_cells, cap), -1, dtype=torch.int32, device=dev)
    lists[sorted_cells[keep], pos[keep]] = order[keep].to(torch.int32)
    spill = int(n - int(keep.sum()))
    mask = lists >= 0
    safe = torch.where(mask, lists, 0).long()
    return IVFIndex(centroids=cent, lists=lists, list_vecs=corpus[safe],
                    list_mask=mask, spill=spill)


def search(index: IVFIndex, queries: torch.Tensor, k: int, nprobe: int = 8
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe the nprobe nearest cells per query. Returns (scores [Q, k],
    corpus row ids [Q, k] int32); scores = -squared-euclidean (higher =
    closer), masked slots ``-inf``."""
    lists, mask = index.lists, index.list_mask
    q = queries.float()
    cent = index.centroids
    d2c = (torch.sum(q * q, 1)[:, None] - 2 * q @ cent.T
           + torch.sum(cent * cent, 1)[None, :])
    cells = torch.sort(-d2c, dim=1, descending=True,
                       stable=True).indices[:, :nprobe]          # [Q, P]
    cap, d = index.list_vecs.shape[1:]
    per_query = max(1, nprobe * cap * d * index.list_vecs.element_size())
    step = max(1, SLAB_BYTES // per_query)
    out_v, out_i = [], []
    for s in range(0, q.shape[0], step):
        qc, cc = q[s:s + step], cells[s:s + step]
        vecs = index.list_vecs[cc]                          # [q, P, cap, d]
        sc = (2.0 * torch.einsum("qd,qpcd->qpc", qc, vecs)
              - index.list_sq[cc]
              - torch.sum(qc * qc, -1)[:, None, None])
        del vecs
        sc = torch.where(mask[cc], sc, torch.full_like(sc, float("-inf")))
        v, i = topk_by_score_then_id(sc.reshape(sc.shape[0], -1),
                                     lists[cc].reshape(sc.shape[0], -1), k)
        out_v.append(v)
        out_i.append(i)
    if not out_v:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(out_v), torch.cat(out_i)


def recall_vs_exact(index: IVFIndex, corpus: torch.Tensor,
                    queries: torch.Tensor, k: int, nprobe: int) -> float:
    from ..core.metrics import knn_indices, set_overlap

    exact = knn_indices(queries, corpus, k)
    _, got = search(index, queries, k, nprobe)
    return float(set_overlap(exact, got))
