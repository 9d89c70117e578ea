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

:func:`pq_adc_select_ref` is a model of the card kernel's selection (pilot
seeds, survivor lists cut by a radix select, the merge pass), held against
:func:`pq_adc_ref` on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph_beam.ref import pairwise_sum

#: Most bytes of gathered LUT entries (and their sums) one chunk holds.
CHUNK_BYTES = 1 << 29
#: The id of an empty list's first threshold: every real row beats it.
EMPTY_ID = 0x7FFFFFFF


def pq_adc_ref(queries: torch.Tensor, codebooks: torch.Tensor,
               codes: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, m * dsub], codebooks [m, ksub, dsub], codes [N, m]
    integer, ``k <= N``. Returns (scores [Q, k] float32, ids [Q, k] int32);
    scores are ``-ADC distance`` (higher = closer)."""
    # imported here: search.quantize imports this package's siblings
    from ...search.quantize import topk_over_rows

    score = _scorer(queries, codebooks, codes)
    m, qn = codebooks.shape[0], queries.shape[0]
    rows = max(1, CHUNK_BYTES // (8 * m * max(qn, 1)))
    return topk_over_rows(score, codes.shape[0], rows, k)


def _scorer(queries: torch.Tensor, codebooks: torch.Tensor,
            codes: torch.Tensor):
    """``score(a, b)``: the [Q, b - a] scores of code rows [a, b), each
    ``-pairwise_sum`` of its m entries of the LUT of ``adc_lut``."""
    # imported here: search.quantize imports this package's siblings
    from ...search.quantize import _code_offsets, adc_lut

    q = queries.float()
    m, ksub, _ = codebooks.shape
    qn = q.shape[0]
    lut = adc_lut(codebooks, q).reshape(qn, m * ksub)

    def score(a, b):
        offs = _code_offsets(codes[a:b], ksub)           # [r, m]
        return -pairwise_sum(lut[:, offs.reshape(-1)].reshape(qn, b - a, m))

    return score


def pq_adc_select_ref(queries: torch.Tensor, codebooks: torch.Tensor,
                      codes: torch.Tensor, k: int, chunk: int, tile: int,
                      cut: int, row_step: int = 1,
                      seed: Optional[tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The card kernel's selection (``csrc/pq_adc.cu`` on
    ``csrc/topk_select.cuh``) on the plain version's scores, over the rows
    ``0, row_step, 2 row_step, ...`` (a pilot's sample, or every row): per
    (query, chunk of ``chunk`` rows) a survivor list that appends the rows
    beating its threshold, cut back to k by the radix select when it holds
    more than ``cut`` pairs after a tile of ``tile`` rows, then the merge
    pass (:func:`~repro_torch.kernels.l2_topk.ref.select_lists_ref`). An
    unseeded list starts at ``(-inf, INT_MAX)``, which every row beats;
    ``seed`` (a pass's [Q, k] answer) starts it at the seed's k-th pair
    (v0, i0) as (v0, i0 + 1). Same result as :func:`pq_adc_ref` over those
    rows."""
    from ..l2_topk.ref import select_lists_ref

    s = _scorer(queries, codebooks, codes)(0, codes.shape[0])[:, ::row_step]
    nq = s.shape[0]
    first = (torch.full((nq,), float("-inf")),
             torch.full((nq,), EMPTY_ID, dtype=torch.int32))
    if seed is not None:
        first = (seed[0][:, -1], seed[1][:, -1] + 1)
    return select_lists_ref(s, row_step, k, chunk, cut + tile, cut, tile,
                            first)
