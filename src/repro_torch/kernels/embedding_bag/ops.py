"""Public EmbeddingBag op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

import torch

from .kernel import embedding_bag_cuda
from .ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  lengths: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """torch.nn.EmbeddingBag's sum / mean over ``[B, L]`` padded bags:
    ``lengths[b]`` live slots a bag, ids clipped to ``[0, V-1]``. Returns
    float32 ``[B, d]``. The reference's Pallas op, with its clip."""
    if table.device.type == "cuda":
        return embedding_bag_cuda(
            table.contiguous(), ids.to(torch.int32).contiguous(),
            lengths.to(device=table.device, dtype=torch.int32).contiguous(),
            mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, lengths, mode)
    raise ValueError(f"embedding_bag: no implementation for device "
                     f"{table.device}")
