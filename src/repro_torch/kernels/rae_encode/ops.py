"""Public RAE encode op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

import torch

from .kernel import rae_encode_cuda
from .ref import rae_encode_ref


def rae_encode(x: torch.Tensor, w_e: torch.Tensor,
               normalize: bool = True) -> torch.Tensor:
    """z = (x @ W_e), optionally L2-normalized per row. x [R, n], w_e [n, m].
    Same signature and default as the reference's Pallas op."""
    if x.device.type == "cuda":
        return rae_encode_cuda(x.float().contiguous(),
                               w_e.float().contiguous(), normalize)
    if x.device.type == "cpu":
        return rae_encode_ref(x, w_e, normalize)
    raise ValueError(f"rae_encode: no implementation for device {x.device}")
