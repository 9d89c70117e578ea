"""Public top-k merge op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

import torch

from ..common import NEG_INF, PAD_ID
from .kernel import topk_merge_cuda
from .ref import topk_merge_ref


def topk_merge(vals: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic scatter-gather top-k merge.

    ``vals``/``ids`` are the [Q, C] gathered per-shard candidates (ids < 0
    = pad; live ids unique per row, since shards are disjoint). Returns
    (vals [Q, k] float32, ids [Q, k] int32) ordered by (value desc, global
    id asc); exhausted slots are ``(NEG_INF, PAD_ID)``. The rules are those
    of the reference's op (``kernels/topk_merge/ops.py``): the id
    tie-break makes the result invariant to how candidates were scattered
    across shards."""
    if vals.device.type == "cpu":
        return topk_merge_ref(vals, ids, k)
    if vals.device.type != "cuda":
        raise ValueError(f"topk_merge: no implementation for device "
                         f"{vals.device}")
    v = vals.float()
    i = ids.to(torch.int32)
    nq, c = v.shape
    if c < k:  # the kernel takes C >= k: widen the pool with pads
        v = torch.cat([v, torch.full((nq, k - c), NEG_INF, device=v.device)],
                      1)
        i = torch.cat([i, torch.full((nq, k - c), PAD_ID, device=i.device,
                                     dtype=torch.int32)], 1)
    return topk_merge_cuda(v.contiguous(), i.contiguous(), k)
