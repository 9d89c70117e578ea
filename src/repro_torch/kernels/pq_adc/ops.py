"""Public PQ ADC scan op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

import torch

from .kernel import pq_adc_cuda
from .ref import pq_adc_ref


def pq_adc(queries: torch.Tensor, codebooks: torch.Tensor,
           codes: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused PQ ADC top-k scan. queries [Q, d] (d = m * dsub), codebooks
    [m, ksub, dsub], codes [N, m] (uint8 on the card). Returns (scores
    [Q, k] float32, ids [Q, k] int32); scores are negative squared
    asymmetric distances (higher = closer), ties to the lower row. ``k >
    N`` pads the tail with ``(-inf, -1)`` after a ``min(k, N)`` scan, as
    the reference's op (``kernels/pq_adc/ops.py``)."""
    q = queries.float()
    cb = codebooks.float()
    m, _, dsub = cb.shape
    if q.shape[1] != m * dsub:
        raise ValueError(f"pq_adc: query dim {q.shape[1]} != m*dsub "
                         f"({m}*{dsub})")
    k_eff = min(k, codes.shape[0])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pq_adc: no implementation for device {q.device}")
    if k_eff == 0:      # an empty corpus: every slot is a pad
        vals = torch.empty((q.shape[0], 0), device=q.device)
        ids = torch.empty((q.shape[0], 0), dtype=torch.int32,
                          device=q.device)
    elif q.device.type == "cpu":
        vals, ids = pq_adc_ref(q, cb, codes, k_eff)
    else:
        vals, ids = pq_adc_cuda(q.contiguous(), cb.contiguous(),
                                codes.contiguous(), k_eff)
    if k_eff < k:
        pad = k - k_eff
        vals = torch.cat([vals, torch.full((vals.shape[0], pad),
                                           float("-inf"), device=q.device)],
                         1)
        ids = torch.cat([ids, torch.full((ids.shape[0], pad), -1,
                                         dtype=torch.int32,
                                         device=q.device)], 1)
    return vals, ids
