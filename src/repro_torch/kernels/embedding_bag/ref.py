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

``embedding_bag_bwd_ref`` is the plain version of the backward kernel (the
gradient of the table, which the TPU had no kernel for: the reference
leaves it to XLA's scatter-add). Every live slot ``(b, l)`` whose clipped
id is ``r`` adds ``grad[b]`` (``grad[b] / max(lengths[b], 1)`` for the
mean, divided as the forward divides) to row ``r``, the slots of a row in
ascending ``(b, l)``, one float32 add after another from zero; untouched
rows are zero. ``sorted_slots`` gives that order (a stable sort of the
``B * L`` slot keys); the CUDA kernel reads the same order and sums each
row's run in it, so the two agree bit for bit, and two runs of a step
give the same bits (an atomic scatter-add would not).
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      lengths: torch.Tensor, mode: str = "mean"
                      ) -> torch.Tensor:
    """table [V, d] float32 / bfloat16; ids [B, L] ints; lengths [B] ints
    -> float32 [B, d] (a float64 table sums in float64, for
    ``gradcheck``)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    b, l = ids.shape
    idc = ids.long().clamp(0, table.shape[0] - 1)
    lens = lengths.to(device=table.device, dtype=torch.int64)
    acc = _acc_dtype(table.dtype)
    s = torch.zeros((b, table.shape[1]), dtype=acc, device=table.device)
    for j in range(l):
        row = table.index_select(0, idc[:, j]).to(acc)
        s = torch.where((j < lens)[:, None], s + row, s)
    if mode == "sum":
        return s
    return s / torch.clamp(lens, min=1)[:, None].to(acc)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def sorted_slots(ids: torch.Tensor, lengths: torch.Tensor, num_rows: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``B * L`` slots of ``[B, L]`` bags ordered by (clipped id, b, l):
    ``(keys, slots)``, int32. A live slot's key is its id clipped to
    ``[0, num_rows - 1]``; a dead one's (``l >= lengths[b]``) is
    ``num_rows``, so the dead slots come last. ``slots`` holds ``b * L + l``.
    A stable sort of keys laid out in ``(b, l)`` order, on the ids' device,
    with no host sync."""
    b, l = ids.shape
    dev = ids.device
    lens = lengths.to(device=dev, dtype=torch.int32)
    live = torch.arange(l, device=dev, dtype=torch.int32)[None, :] \
        < lens[:, None]
    keys = torch.where(live, ids.clamp(0, num_rows - 1).to(torch.int32),
                       torch.full_like(ids, num_rows, dtype=torch.int32))
    keys, slots = torch.sort(keys.reshape(-1), stable=True)
    return keys, slots.to(torch.int32)


def embedding_bag_bwd_ref(grad: torch.Tensor, ids: torch.Tensor,
                          lengths: torch.Tensor, mode: str, num_rows: int
                          ) -> torch.Tensor:
    """grad [B, d] (the bags' gradient); ids [B, L]; lengths [B] -> float32
    [num_rows, d] (float64 for a float64 ``grad``), the gradient of the
    table, summed in ``sorted_slots``' order."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    dev = grad.device
    b, l = ids.shape
    d = grad.shape[1]
    acc_dtype = _acc_dtype(grad.dtype)
    out = torch.zeros((num_rows, d), dtype=acc_dtype, device=dev)
    keys, slots = sorted_slots(ids.to(dev), lengths.to(dev), num_rows)
    n_live = int((keys < num_rows).sum())
    if n_live == 0:
        return out
    keys, slots = keys[:n_live].long(), slots[:n_live].long()
    rows = grad.to(acc_dtype)
    if mode == "mean":
        lens = lengths.to(device=dev, dtype=torch.int64)
        rows = rows / torch.clamp(lens, min=1)[:, None].to(acc_dtype)
    contrib = rows.index_select(0, slots // l)
    start = torch.ones(n_live, dtype=torch.bool, device=dev)
    start[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(start.long(), 0) - 1          # each slot's run
    first = torch.nonzero(start).flatten()           # each run's start
    pos = torch.arange(n_live, device=dev) - first[run]
    acc = torch.zeros((first.numel(), d), dtype=acc_dtype, device=dev)
    for r in range(int(pos.max()) + 1):              # the r-th add of a run
        sel = torch.nonzero(pos == r).flatten()
        at = run[sel]
        acc[at] = acc[at] + contrib[sel]
    out[keys[first]] = acc
    return out
