"""Public EmbeddingBag ops: the CUDA kernels on a CUDA tensor, the plain
versions on a CPU tensor. Nothing else selects between them.

``embedding_bag`` is the forward op. ``embedding_bag_bwd`` gives the
table's gradient. Two ``torch.autograd.Function``s join them for training:
``embedding_bag_autograd`` (the bag: forward ``embedding_bag``, backward
``embedding_bag_bwd``) and ``embedding_lookup`` (a row lookup: forward
``index_select``, the reference's ``jnp.take`` outside any kernel;
backward ``embedding_bag_bwd`` over bags of one in ``sum`` mode). Both
backwards sum each row's gradient in one fixed order, where autograd's own
``index_select`` backward is an atomic ``index_add_`` on the card.
"""
from __future__ import annotations

import torch

from .kernel import embedding_bag_bwd_cuda, embedding_bag_cuda
from .ref import embedding_bag_bwd_ref, embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  lengths: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """torch.nn.EmbeddingBag's sum / mean over ``[B, L]`` padded bags:
    ``lengths[b]`` live slots a bag, ids clipped to ``[0, V-1]``. Returns
    float32 ``[B, d]``. The reference's Pallas op, with its clip."""
    if table.device.type == "cuda":
        return embedding_bag_cuda(
            table.contiguous(), ids.to(torch.int32).contiguous(),
            lengths.to(device=table.device, dtype=torch.int32).contiguous(),
            mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, lengths, mode)
    raise ValueError(f"embedding_bag: no implementation for device "
                     f"{table.device}")


def embedding_bag_bwd(grad: torch.Tensor, ids: torch.Tensor,
                      lengths: torch.Tensor, mode: str, num_rows: int
                      ) -> torch.Tensor:
    """The gradient of ``embedding_bag(table, ids, lengths, mode)``'s table
    (``num_rows`` rows) for the bags' gradient ``grad [B, d]``: float32
    ``[num_rows, d]``, each row summed over its live slots in ascending
    ``(b, l)``, untouched rows zero."""
    if grad.device.type == "cuda":
        dev = grad.device
        return embedding_bag_bwd_cuda(
            grad.float().contiguous(),
            ids.to(device=dev, dtype=torch.int32).contiguous(),
            lengths.to(device=dev, dtype=torch.int32).contiguous(), mode,
            num_rows)
    if grad.device.type == "cpu":
        return embedding_bag_bwd_ref(grad, ids, lengths, mode, num_rows)
    raise ValueError(f"embedding_bag_bwd: no implementation for device "
                     f"{grad.device}")


class EmbeddingBagFunction(torch.autograd.Function):
    """The bag with its gradient: forward ``embedding_bag``, backward
    ``embedding_bag_bwd`` (the module's functions, looked up at call
    time)."""

    @staticmethod
    def forward(ctx, table, ids, lengths, mode):
        ctx.save_for_backward(ids, lengths)
        ctx.mode, ctx.rows, ctx.dtype = mode, table.shape[0], table.dtype
        return embedding_bag(table, ids, lengths, mode)

    @staticmethod
    def backward(ctx, grad):
        ids, lengths = ctx.saved_tensors
        g = embedding_bag_bwd(grad, ids, lengths, ctx.mode, ctx.rows)
        return g.to(ctx.dtype), None, None, None


class EmbeddingLookupFunction(torch.autograd.Function):
    """``table[idx]`` with its gradient: forward ``index_select``, backward
    ``embedding_bag_bwd`` over bags of one (``sum``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        ones = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
        g = embedding_bag_bwd(grad, idx.reshape(-1, 1), ones, "sum",
                              ctx.rows)
        return g.to(ctx.dtype), None


def embedding_bag_autograd(table: torch.Tensor, ids: torch.Tensor,
                           lengths: torch.Tensor, mode: str = "mean"
                           ) -> torch.Tensor:
    """``embedding_bag`` that autograd can differentiate in ``table``."""
    return EmbeddingBagFunction.apply(table, ids, lengths, mode)


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, idx)`` for in-range int64 ``idx [N]``, which
    autograd can differentiate in ``table``."""
    return EmbeddingLookupFunction.apply(table, idx)
