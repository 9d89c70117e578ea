"""Plain PyTorch version of the quantized gather + score + beam-merge hop.

One HNSW traversal hop over stored codes, term for term the reference's
``kernels/graph_beam_q/ref.py``. Both payloads reduce to one affine form::

    score[q, w] = contract(q_op[q], codes[id]) + q_bias[q] - node_bias[id]

* ``mode="sq8"``: ``q_op = 2 q * step``, ``q_bias = 2 q.vmin - |q|^2``,
  ``node_bias = |decode(c)|^2``; the contraction is a dot with the raw
  uint8 codes, and the score is ``-|q - decode(c)|^2``.
* ``mode="pq"``: ``q_op`` is the negated flattened ADC LUT ``[Q, m *
  ksub]`` and both biases are zero; the contraction sums the m LUT entries
  the code row selects, giving ``-ADC distance``. ``ksub`` is the LUT
  stride (the trained codebook width, which may be < 2**bits).

The contraction is summed by ``kernels/graph_beam/ref.py:pairwise_sum``, a
fixed tree, so a row's answer does not depend on its batch-mates and the
CUDA kernel (``csrc/graph_beam_q.cu``) agrees bit for bit. The merge is the
f32 hop's: ties to the beam, then to the lower slot; pads ``(NEG_INF,
-1)``. :func:`graph_traverse_q_ref` is the card's one-launch quantized
traversal, one query at a time, on those hops.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph_beam.ref import merge_into_beam, pairwise_sum, traverse_rows


def check_mode(mode: str, ksub: int) -> None:
    if mode not in ("sq8", "pq"):
        raise ValueError(f"graph_beam_q: mode must be 'sq8' or 'pq', "
                         f"got {mode!r}")
    if mode == "pq" and ksub < 1:
        raise ValueError("graph_beam_q: pq mode needs ksub >= 1 (the LUT "
                         "stride)")


def check_operand(mode: str, ksub: int, dop: int, c: int) -> None:
    if mode == "sq8" and dop != c:
        raise ValueError(f"graph_beam_q: sq8 operand dim {dop} != code dim "
                         f"{c}")
    if mode == "pq" and dop != c * ksub:
        raise ValueError(f"graph_beam_q: pq operand dim {dop} != m*ksub = "
                         f"{c * ksub}")


def graph_beam_q_ref(q_op: torch.Tensor, q_bias: torch.Tensor,
                     codes: torch.Tensor, node_bias: torch.Tensor,
                     nbr_ids: torch.Tensor, beam_v: torch.Tensor,
                     beam_i: torch.Tensor,
                     db_mask: Optional[torch.Tensor] = None,
                     mode: str = "sq8", ksub: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """q_op [Q, Dop] float32 (sq8: Dop = C; pq: Dop = C * ksub); q_bias
    [Q]; codes [N, C] uint8; node_bias [N]; nbr_ids [Q, W] int (-1 =
    masked slot); beam_v/beam_i [Q, ef] sorted descending. ``db_mask``
    (bool [N]) tombstones rows: a masked candidate is a -1 slot. Returns
    the merged (vals [Q, ef] float32, ids [Q, ef] int32)."""
    check_mode(mode, ksub)
    qo = q_op.float()
    ids = nbr_ids.to(torch.int32)
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    if db_mask is not None:
        valid = valid & db_mask.to(torch.bool)[safe]
    check_operand(mode, ksub, qo.shape[1], codes.shape[1])
    s = candidate_scores_q(qo, q_bias, codes, node_bias, safe, mode, ksub)
    return merge_into_beam(beam_v.float(), beam_i.to(torch.int32), s, ids,
                           valid)


def candidate_scores_q(q_op: torch.Tensor, q_bias: torch.Tensor,
                       codes: torch.Tensor, node_bias: torch.Tensor,
                       safe: torch.Tensor, mode: str, ksub: int
                       ) -> torch.Tensor:
    """``(contract(q_op, codes[id]) + q_bias) - node_bias[id]`` of the
    code rows ``safe`` [Q, W] (valid ids) against q_op [Q, Dop], the
    contraction summed by :func:`pairwise_sum`."""
    qo = q_op.float()
    g = codes[safe]                                          # [Q, W, C]
    if mode == "sq8":
        s = pairwise_sum(g.float() * qo[:, None, :])
    else:
        m = codes.shape[1]
        offs = g.long() + torch.arange(m, device=g.device) * ksub
        s = pairwise_sum(torch.gather(qo, 1, offs.reshape(qo.shape[0], -1))
                         .reshape(offs.shape))
    s = s + q_bias.float()[:, None]
    return s - node_bias.float()[safe]


def graph_traverse_q_ref(q_op: torch.Tensor, q_bias: torch.Tensor,
                         codes: torch.Tensor, node_bias: torch.Tensor,
                         nbrs0: torch.Tensor, upper: torch.Tensor,
                         entry: int, ef: int, mode: str = "sq8",
                         ksub: int = 0, alive: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One query at a time, the card's quantized traversal kernel
    (``csrc/graph_beam_q.cu``, the traversal of ``csrc/graph_traverse.cuh``
    with a code payload) in its order of work
    (:func:`~repro_torch.kernels.graph_beam.ref.traverse_rows`), each step
    scored and merged as :func:`graph_beam_q_ref` does. Returns (beam_v
    [Q, ef], beam_i [Q, ef] int32, evals [Q] int64, hops [Q] int32)."""
    check_mode(mode, ksub)
    check_operand(mode, ksub, q_op.shape[1], codes.shape[1])
    q_op, q_bias = q_op.cpu(), q_bias.cpu()
    codes, node_bias = codes.cpu(), node_bias.cpu()

    def score(r, safe):
        return candidate_scores_q(q_op[r:r + 1], q_bias[r:r + 1], codes,
                                  node_bias, safe[None, :], mode, ksub)[0]

    return traverse_rows(score, q_op.shape[0], codes.shape[0], nbrs0, upper,
                         entry, ef, alive)
