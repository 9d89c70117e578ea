"""Plain PyTorch version of the RAE encode: ``x @ W_e``, optionally
L2-normalized per row. The CPU path of :func:`..ops.rae_encode`, and what
the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def rae_encode_ref(x: torch.Tensor, w_e: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    z = x.float() @ w_e.float()
    if normalize:
        z = z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                            min=1e-12)
    return z
