"""Binding of the hand-written CUDA EmbeddingBag (``csrc/embedding_bag.cu``):
the forward, and the backward that gives the table's gradient.

The forward replaces the TPU kernel ``embedding_bag_pallas``
(``src/repro/kernels/embedding_bag/kernel.py``); the backward replaces no
TPU kernel (the reference's gradient is XLA's scatter-add) and is there so
that a training step sums each row's gradient in one fixed order. The
source file says how each is laid out and what bounds it. A wrapper checks
what its kernel takes, allocates the output, launches on PyTorch's current
stream and raises if the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import sorted_slots

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embedding_bag_launch.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.embedding_bag_launch.restype = i
    lib.embedding_bag_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.embedding_bag_bwd_launch.restype = i
    return lib


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       lengths: torch.Tensor, mode: str = "mean"
                       ) -> torch.Tensor:
    """table [V, d] float32 or bfloat16, ids [B, L] int32, lengths [B]
    int32, contiguous on one CUDA device -> float32 [B, d]: the sum (or
    mean) of each bag's first ``min(lengths[b], L)`` rows, ids clipped to
    ``[0, V-1]``."""
    dev = table.device
    if dev.type != "cuda" or ids.device != dev or lengths.device != dev:
        raise ValueError(f"embedding_bag_cuda needs every tensor on one "
                         f"CUDA device, got {table.device}, {ids.device}, "
                         f"{lengths.device}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"embedding_bag_cuda takes a float32 or bfloat16 "
                         f"table, got {table.dtype}")
    if ids.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"embedding_bag_cuda takes int32 ids and lengths, "
                         f"got {ids.dtype} and {lengths.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or lengths.shape != ids.shape[:1]:
        raise ValueError(f"embedding_bag_cuda shapes: table "
                         f"{tuple(table.shape)}, ids {tuple(ids.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("embedding_bag_cuda takes contiguous tensors")
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    v, d = table.shape
    b, l = ids.shape
    if v < 1 or d < 1 or v >= 2 ** 31 or b >= 2 ** 31 or l >= 2 ** 31:
        raise ValueError(f"embedding_bag_cuda shapes out of range: table "
                         f"{v}x{d}, ids {b}x{l}")
    out = torch.empty((b, d), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().embedding_bag_launch(
        table.data_ptr(), _DTYPES[table.dtype], ids.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, l, v, d,
        int(mode == "mean"), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed (cuda error "
                           f"{err})")
    if b:
        _build.count_launch(embedding_bag_cuda)
    return out


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
embedding_bag_cuda.launches = 0


def embedding_bag_bwd_cuda(grad: torch.Tensor, ids: torch.Tensor,
                           lengths: torch.Tensor, mode: str, num_rows: int
                           ) -> torch.Tensor:
    """grad [B, d] float32, ids [B, L] int32, lengths [B] int32, contiguous
    on one CUDA device -> float32 [num_rows, d]: the gradient of the table
    of ``embedding_bag_cuda(table, ids, lengths, mode)``. The slots are
    ordered by (clipped id, b, l) with a stable ``torch.sort``
    (``ref.sorted_slots``) and the output zero-filled; the kernel sums each
    touched row's run of slots in that order and writes the row once."""
    dev = grad.device
    if dev.type != "cuda" or ids.device != dev or lengths.device != dev:
        raise ValueError(f"embedding_bag_bwd_cuda needs every tensor on one "
                         f"CUDA device, got {grad.device}, {ids.device}, "
                         f"{lengths.device}")
    if grad.dtype != torch.float32:
        raise ValueError(f"embedding_bag_bwd_cuda takes a float32 gradient, "
                         f"got {grad.dtype}")
    if ids.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"embedding_bag_bwd_cuda takes int32 ids and "
                         f"lengths, got {ids.dtype} and {lengths.dtype}")
    if grad.dim() != 2 or ids.dim() != 2 or lengths.shape != ids.shape[:1] \
            or grad.shape[0] != ids.shape[0]:
        raise ValueError(f"embedding_bag_bwd_cuda shapes: grad "
                         f"{tuple(grad.shape)}, ids {tuple(ids.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if not (grad.is_contiguous() and ids.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("embedding_bag_bwd_cuda takes contiguous tensors")
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    b, l = ids.shape
    d = grad.shape[1]
    if num_rows < 1 or d < 1 or num_rows >= 2 ** 31 - 1 or b * l >= 2 ** 31:
        raise ValueError(f"embedding_bag_bwd_cuda shapes out of range: "
                         f"{num_rows} rows of {d}, ids {b}x{l}")
    out = torch.zeros((num_rows, d), device=dev, dtype=torch.float32)
    if b * l == 0:
        return out
    keys, slots = sorted_slots(ids, lengths, num_rows)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().embedding_bag_bwd_launch(
        grad.data_ptr(), lengths.data_ptr(), keys.data_ptr(),
        slots.data_ptr(), out.data_ptr(), b * l, l, num_rows, d,
        int(mode == "mean"), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag_bwd kernel launch failed (cuda "
                           f"error {err})")
    _build.count_launch(embedding_bag_bwd_cuda)
    return out


embedding_bag_bwd_cuda.launches = 0
