"""Plain PyTorch version of EmbeddingBag (row gather + masked segment sum).

``out[b] = sum_{j < min(lengths[b], L)} table[clip(ids[b, j])]`` in
float32, the rows added one bag slot at a time in the order ``j = 0 ..
L-1``, as the reference's Pallas kernel accumulates them
(``src/repro/kernels/embedding_bag/kernel.py:24``); ``mode="mean"``
divides by ``max(lengths[b], 1)``. Ids are clipped to ``[0, V-1]`` as the
reference's op (``ops.py:22``) and its model path (``models/common.py``)
clip them; the reference's ``ref.py`` reads out-of-range ids through
``jnp.take``'s fill instead (ROADMAP C6). A slot at or past ``lengths[b]``
is never added, where the Pallas kernel adds it times zero: the two agree
for a finite table, and differ only where a dead slot's row is not finite
(NaN times zero is NaN there, and nothing here).

The CPU path and the tests use it; on the card ``ops.py`` runs the CUDA
kernel (``csrc/embedding_bag.cu``), which adds the same rows in the same
order and agrees with it bit for bit.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      lengths: torch.Tensor, mode: str = "mean"
                      ) -> torch.Tensor:
    """table [V, d] float32 / bfloat16; ids [B, L] ints; lengths [B] ints
    -> float32 [B, d]."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    b, l = ids.shape
    idc = ids.long().clamp(0, table.shape[0] - 1)
    lens = lengths.to(device=table.device, dtype=torch.int64)
    s = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                    device=table.device)
    for j in range(l):
        row = table.index_select(0, idc[:, j]).float()
        s = torch.where((j < lens)[:, None], s + row, s)
    if mode == "sum":
        return s
    return s / torch.clamp(lens, min=1)[:, None].float()
