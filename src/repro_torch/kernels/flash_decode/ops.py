"""Public decode-attention op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

import torch

from .kernel import flash_decode_cuda
from .ref import flash_decode_ref


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur_len) -> torch.Tensor:
    """Single-token decode attention. q [B, kh, g, dh] (kh-major grouped);
    caches [B, S, kh, dh] float32 or bfloat16; attends to cache positions
    ``< cur_len`` (an int, or an int tensor on the caches' device, which
    the kernel reads there). Returns float32 [B, kh, g, dh]; zeros where
    ``cur_len <= 0``."""
    if k_cache.device.type == "cuda":
        cur_len = torch.as_tensor(cur_len, dtype=torch.int32,
                                  device=k_cache.device).reshape(())
        return flash_decode_cuda(q.float().contiguous(), k_cache.contiguous(),
                                 v_cache.contiguous(), cur_len)
    if k_cache.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, cur_len)
    raise ValueError(f"flash_decode: no implementation for device "
                     f"{k_cache.device}")
