"""Plain PyTorch version of the fused PQ ADC scan + top-k.

:func:`pq_adc_ref` is the kernel's own function: the per-query LUT of
:func:`repro_torch.search.quantize.adc_lut`, each code row's distance as
the :func:`~repro_torch.kernels.graph_beam.ref.pairwise_sum` of its m
looked-up entries, score ``-dist``, and the k best (score, row) pairs under
(score descending, row ascending), ``lax.top_k``'s tie rule. The CUDA
kernel (``csrc/pq_adc.cu``) sums in the same trees and agrees bit for bit.

The reference's oracle materializes the ``[Q, N * m]`` gather (8.4 GB at
Q = 256, N = 1M); this version scans the rows in chunks and merges the
chunk lists by a stable sort, which keeps the tie rule, so it runs at the
main path's full size too.
"""
from __future__ import annotations

import torch

from ..graph_beam.ref import pairwise_sum

#: Most bytes of gathered LUT entries (and their sums) one chunk holds.
CHUNK_BYTES = 1 << 29


def pq_adc_ref(queries: torch.Tensor, codebooks: torch.Tensor,
               codes: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, m * dsub], codebooks [m, ksub, dsub], codes [N, m]
    integer, ``k <= N``. Returns (scores [Q, k] float32, ids [Q, k] int32);
    scores are ``-ADC distance`` (higher = closer)."""
    # imported here: search.quantize imports this package's siblings
    from ...search.quantize import _code_offsets, adc_lut, topk_over_rows

    q = queries.float()
    m, ksub, _ = codebooks.shape
    qn = q.shape[0]
    lut = adc_lut(codebooks, q).reshape(qn, m * ksub)

    def score(a, b):
        offs = _code_offsets(codes[a:b], ksub)           # [r, m]
        return -pairwise_sum(lut[:, offs.reshape(-1)].reshape(qn, b - a, m))

    rows = max(1, CHUNK_BYTES // (8 * m * max(qn, 1)))
    return topk_over_rows(score, codes.shape[0], rows, k)
