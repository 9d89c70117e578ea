"""Binding of the hand-written CUDA top-k merge (``csrc/topk_merge.cu``).

Replaces the TPU kernel ``topk_merge_pallas``
(``src/repro/kernels/topk_merge/kernel.py``); the source file says how it
is laid out and what bounds it. The wrapper checks what the kernel takes,
allocates the outputs, launches on PyTorch's current stream and raises if
the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_merge")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_merge_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.topk_merge_launch.restype = i
    lib.topk_merge_smem.argtypes = [i]
    lib.topk_merge_smem.restype = ctypes.c_longlong
    return lib


#: Widest candidate row the kernel takes (``kMaxC`` of the source): the row
#: is sorted in one block's shared memory, 12 bytes a slot padded to a power
#: of two. ``KNOB_LADDER[-1] * 8 = 2048 * 8`` shards fits.
MAX_C = 16384


def topk_merge_cuda(vals: torch.Tensor, ids: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """vals [Q, C] float32, ids [Q, C] int32 (ids < 0 = pad), contiguous on
    one CUDA device, 1 <= k <= C <= MAX_C. Returns (vals [Q, k] float32,
    ids [Q, k] int32) ordered by (value desc, id asc), drained slots
    ``(NEG_INF, PAD_ID)``."""
    dev = vals.device
    if dev.type != "cuda" or ids.device != dev:
        raise ValueError(f"topk_merge_cuda needs both tensors on one CUDA "
                         f"device, got {vals.device} and {ids.device}")
    if vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"topk_merge_cuda takes float32 values and int32 "
                         f"ids, got {vals.dtype} and {ids.dtype}")
    if vals.dim() != 2 or ids.shape != vals.shape:
        raise ValueError(f"topk_merge_cuda shapes: vals {tuple(vals.shape)}, "
                         f"ids {tuple(ids.shape)}")
    if not (vals.is_contiguous() and ids.is_contiguous()):
        raise ValueError("topk_merge_cuda takes contiguous tensors")
    nq, c = vals.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"topk_merge kernel supports 1 <= C <= {MAX_C} "
                         f"candidates a row (sorted in one block's shared "
                         f"memory), got C={c}")
    if not 1 <= k <= c:
        raise ValueError(f"topk_merge kernel needs 1 <= k <= C, got k={k}, "
                         f"C={c} (ops.topk_merge pads the pool)")
    if nq >= 2 ** 31:
        raise ValueError(f"topk_merge_cuda: Q={nq} out of range")
    lib = _lib()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if lib.topk_merge_smem(c) > limit:
        raise ValueError(f"topk_merge kernel: C={c} needs "
                         f"{lib.topk_merge_smem(c)} bytes of shared memory, "
                         f"the card gives a block {limit}")
    out_v = torch.empty((nq, k), device=dev, dtype=torch.float32)
    out_i = torch.empty((nq, k), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.topk_merge_launch(vals.data_ptr(), ids.data_ptr(),
                                out_v.data_ptr(), out_i.data_ptr(), nq, c, k,
                                stream)
    if err != 0:
        raise RuntimeError(f"topk_merge kernel launch failed (cuda error "
                           f"{err})")
    if nq:
        _build.count_launch(topk_merge_cuda)
    return out_v, out_i


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
topk_merge_cuda.launches = 0
