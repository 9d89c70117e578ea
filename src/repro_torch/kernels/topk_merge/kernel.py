"""Binding of the hand-written CUDA top-k merge (``csrc/topk_merge.cu``).

Replaces the TPU kernel ``topk_merge_pallas``
(``src/repro/kernels/topk_merge/kernel.py``); the source file says how it
is laid out and what bounds it. :func:`plan` is the launch the kernel makes
for a row width (a block a row, of 128 threads up to ``NARROW_MAX_C``
candidates and of 512 above), which ``ref.topk_merge_select_ref`` models
on the CPU. The wrapper checks what the kernel takes, allocates the
outputs, launches on PyTorch's current stream and raises if the launch was
refused.
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
    lib.topk_merge_smem.argtypes = [i, i]
    lib.topk_merge_smem.restype = ctypes.c_longlong
    for name in ("topk_merge_max_c", "topk_merge_narrow_max_c",
                 "topk_merge_narrow_threads", "topk_merge_wide_threads",
                 "topk_merge_rank_max_k", "topk_merge_digit_bits"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    if (lib.topk_merge_max_c(), lib.topk_merge_narrow_max_c(),
            lib.topk_merge_narrow_threads(), lib.topk_merge_wide_threads(),
            lib.topk_merge_rank_max_k(), lib.topk_merge_digit_bits(),
            lib.topk_merge_smem(320, 40),
            lib.topk_merge_smem(16384, 2048)) != (
                MAX_C, NARROW_MAX_C, NARROW_THREADS, WIDE_THREADS,
                RANK_MAX_K, DIGIT_BITS, smem_bytes(320, 40),
                smem_bytes(16384, 2048)):
        raise RuntimeError("topk_merge: the library's geometry differs from "
                           "the wrapper's")
    return lib


#: Widest candidate row the kernel takes (``kMaxC`` of the source): a block
#: of ``WIDE_THREADS`` holds it in registers, 32 keys a thread.
#: ``KNOB_LADDER[-1] * 8 = 2048 * 8`` shards fits.
MAX_C = 16384
#: The kernel's geometry (``kNarrowMaxC``, ``kNarrowThreads``,
#: ``kWideThreads`` of the source): a block a row, of ``NARROW_THREADS`` up
#: to ``NARROW_MAX_C`` candidates and of ``WIDE_THREADS`` above.
NARROW_MAX_C = 1024
NARROW_THREADS = 128
WIDE_THREADS = 512
#: Up to this k the survivors are ordered by counting each one's rank
#: (``kRankMaxK``); above it by a bitonic sort of ``sort_width(k)`` slots.
RANK_MAX_K = 128
#: Bits a pass of the narrow blocks' cut counts (``kDigit``): 32 bins,
#: one a lane.
DIGIT_BITS = 5


def sort_width(k: int) -> int:
    """Slots of the survivor sort: the power of two >= k (at least 2)."""
    return max(2, 1 << (k - 1).bit_length())


def plan(c: int, k: int) -> tuple[int, int, int]:
    """(threads a row, keys a thread, sort width) of a launch over rows of
    ``c`` candidates, a block a row: ``NARROW_THREADS`` up to
    ``NARROW_MAX_C``, each thread holding the fewest keys of 1, 2, 3, 4, 8
    that cover the row; ``WIDE_THREADS`` above, 32 keys a thread."""
    if not 1 <= k <= c <= MAX_C:
        raise ValueError(f"topk_merge plan: need 1 <= k <= C <= {MAX_C}, "
                         f"got k={k}, C={c}")
    if c <= NARROW_MAX_C:
        keys = next(r for r in (1, 2, 3, 4, 8) if NARROW_THREADS * r >= c)
        return NARROW_THREADS, keys, sort_width(k)
    return WIDE_THREADS, MAX_C // WIDE_THREADS, sort_width(k)


def smem_bytes(c: int, k: int) -> int:
    """Shared memory of a launch (``topk_merge_smem`` of the source): the
    survivors' keys and values and 32 spare slots (12 bytes a slot); a
    warp's two buffers of OR / AND words and its keep total; the bin
    counts, two buffers of 32 a warp in a narrow block, one 257-bin
    histogram (264 ints) in a wide one."""
    threads, _, p = plan(c, k)
    warps = threads // 32
    bins = 2 * warps * 32 if threads == NARROW_THREADS else 264
    return 12 * (p + 32) + 4 * (9 * warps + bins)


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
                         f"candidates a row (held in one block's registers), "
                         f"got C={c}")
    if not 1 <= k <= c:
        raise ValueError(f"topk_merge kernel needs 1 <= k <= C, got k={k}, "
                         f"C={c} (ops.topk_merge pads the pool)")
    if nq >= 2 ** 31:
        raise ValueError(f"topk_merge_cuda: Q={nq} out of range")
    lib = _lib()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if lib.topk_merge_smem(c, k) > limit:
        raise ValueError(f"topk_merge kernel: C={c}, k={k} needs "
                         f"{lib.topk_merge_smem(c, k)} bytes of shared "
                         f"memory, the card gives a block {limit}")
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

