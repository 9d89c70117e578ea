"""Public quantized-hop op: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor. Nothing else selects between them."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import graph_beam_q_cuda
from .ref import check_mode, graph_beam_q_ref


def graph_beam_q(q_op: torch.Tensor, q_bias: torch.Tensor,
                 codes: torch.Tensor, node_bias: torch.Tensor,
                 nbr_ids: torch.Tensor, beam_v: torch.Tensor,
                 beam_i: torch.Tensor,
                 db_mask: Optional[torch.Tensor] = None, mode: str = "sq8",
                 ksub: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused quantized traversal hop: gather the ``nbr_ids`` rows of
    the stored uint8 ``codes``, score them by the affine form of
    :mod:`.ref` and merge them into the running ``(beam_v, beam_i)``
    top-ef beam. Shapes and rules are those of :func:`.ref.graph_beam_q_ref`
    and of the reference's op (``kernels/graph_beam_q/ops.py``);
    ``db_mask`` tombstones are demoted to -1 ids before the kernel, which
    takes no mask of its own."""
    check_mode(mode, ksub)
    if q_op.device.type == "cpu":
        return graph_beam_q_ref(q_op, q_bias, codes, node_bias, nbr_ids,
                                beam_v, beam_i, db_mask, mode, ksub)
    if q_op.device.type != "cuda":
        raise ValueError(f"graph_beam_q: no implementation for device "
                         f"{q_op.device}")
    ids = nbr_ids.to(torch.int32)
    if db_mask is not None:
        safe = torch.where(ids >= 0, ids, torch.zeros_like(ids)).long()
        ids = torch.where((ids >= 0) & db_mask.to(torch.bool)[safe], ids,
                          torch.full_like(ids, -1))
    return graph_beam_q_cuda(q_op.float().contiguous(),
                             q_bias.float().contiguous(), codes.contiguous(),
                             node_bias.float().contiguous(), ids.contiguous(),
                             beam_v.float().contiguous(),
                             beam_i.to(torch.int32).contiguous(), mode, ksub)
