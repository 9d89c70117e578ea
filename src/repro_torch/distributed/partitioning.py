"""Corpus partitioning for sharded serving: the two partitioners of the
reference's ``distributed/partitioning.py`` (lines 235-285). Its mesh and
parameter-sharding helpers are JAX-only and have no counterpart here.

Both return disjoint covers of the rows as int32 global-id arrays,
ascending within each shard: the merge's tie-break (lower global id) then
matches each shard's own tie order, which is what makes sharded answers
invariant to the shard count.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def partition_rows(n: int, n_shards: int) -> list[np.ndarray]:
    """Contiguous, balanced row ranges: shard i gets ``n // n_shards`` rows
    (+1 for the first ``n % n_shards`` shards), so a ragged corpus never
    drops its tail."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(n_shards, max(n, 1))
    base, rem = divmod(n, n_shards)
    parts, start = [], 0
    for i in range(n_shards):
        size = base + (1 if i < rem else 0)
        parts.append(np.arange(start, start + size, dtype=np.int32))
        start += size
    return parts


def partition_ivf_cells(corpus, n_shards: int, n_cells: int = 0,
                        kmeans_iters: int = 10, seed: int = 0,
                        init: Optional[np.ndarray] = None
                        ) -> list[np.ndarray]:
    """Cluster the corpus into k-means cells and bin-pack whole cells onto
    shards (largest cell first, onto the lightest shard). The k-means runs
    on the corpus's device (a tensor's, or the CPU for a numpy array) from
    the port's seeded init, or from ``init`` rows (see ``search.ivf``)."""
    from ..search.ivf import kmeans

    x = torch.as_tensor(corpus, dtype=torch.float32)
    n = int(x.shape[0])
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(n_shards, max(n, 1))
    if n_shards == 1:
        return [np.arange(n, dtype=np.int32)]
    n_cells = min(n_cells or 8 * n_shards, n)
    _, assign = kmeans(x, n_cells, iters=kmeans_iters, seed=seed, init=init)
    assign = assign.cpu().numpy()
    members = [np.flatnonzero(assign == c) for c in range(n_cells)]
    order = np.argsort([-len(m) for m in members], kind="stable")
    loads = np.zeros(n_shards, np.int64)
    buckets: list[list[np.ndarray]] = [[] for _ in range(n_shards)]
    for c in order:
        s = int(np.argmin(loads))
        buckets[s].append(members[c])
        loads[s] += len(members[c])
    return [np.sort(np.concatenate(b)).astype(np.int32) if b
            else np.empty(0, np.int32) for b in buckets]
