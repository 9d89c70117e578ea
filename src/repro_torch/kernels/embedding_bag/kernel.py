"""Binding of the hand-written CUDA EmbeddingBag (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``embedding_bag_pallas``
(``src/repro/kernels/embedding_bag/kernel.py``); the source file says how
it is laid out and what bounds it. The wrapper checks what the kernel
takes, allocates the output, launches on PyTorch's current stream and
raises if the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embedding_bag_launch.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.embedding_bag_launch.restype = i
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
