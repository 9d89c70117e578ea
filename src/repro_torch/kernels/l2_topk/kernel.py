"""Binding of the hand-written CUDA scan + top-k (``csrc/l2_topk.cu``).

Replaces the TPU kernel ``l2_topk_pallas``
(``src/repro/kernels/l2_topk/kernel.py``); the source file says how it is
laid out and what bounds it. The wrapper checks what the kernel takes,
splits the corpus into chunks so that about four blocks per SM run pass 1,
allocates outputs and scratch, launches on PyTorch's current stream and
raises if a launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ROW_TILE = 64        # corpus rows a pass-1 block scores per step
_BLOCKS_PER_SM = 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("l2_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l2_topk_launch.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.l2_topk_launch.restype = i
    lib.l2_topk_plan.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i),
                                 ctypes.POINTER(i)]
    lib.l2_topk_plan.restype = i
    lib.l2_topk_max_k.argtypes = []
    lib.l2_topk_max_k.restype = i
    return lib


def max_k() -> int:
    """Largest k the kernel takes: its per-query candidate buffer of 4096
    pairs in shared memory must hold k pairs plus one 64-row tile."""
    return _lib().l2_topk_max_k()


def plan_chunks(n_queries: int, n_rows: int, k: int, query_tile: int,
                n_sms: int) -> tuple[int, int]:
    """(rows per chunk, chunks) for pass 1: enough (query tile, chunk)
    blocks for about four per SM, chunks a multiple of the row tile and at
    least 2k rows, so a chunk's k-list is mostly real candidates."""
    q_tiles = -(-n_queries // query_tile)
    want = max(1, -(-(_BLOCKS_PER_SM * n_sms) // q_tiles))
    chunk = -(-max(n_rows, 1) // want)
    chunk = max(chunk, 2 * k, _ROW_TILE)
    chunk = -(-chunk // _ROW_TILE) * _ROW_TILE
    return chunk, max(1, -(-n_rows // chunk))


def l2_topk_scan_cuda(q: torch.Tensor, d: torch.Tensor, d_sq: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best (2 q.d - d_sq, id) pairs per query, pads (NEG_INF, -1)
    included, ordered by (score desc, id asc). q [Q, dim], d [N, dim],
    d_sq [N]: contiguous float32 on one CUDA device. Returns (vals [Q, k]
    float32, ids [Q, k] int32)."""
    dev = q.device
    if dev.type != "cuda" or d.device != dev or d_sq.device != dev:
        raise ValueError(f"l2_topk_scan_cuda needs all tensors on one CUDA "
                         f"device, got {q.device}, {d.device}, "
                         f"{d_sq.device}")
    if any(t.dtype != torch.float32 for t in (q, d, d_sq)):
        raise ValueError("l2_topk_scan_cuda takes float32 tensors")
    if (q.dim() != 2 or d.dim() != 2 or q.shape[1] != d.shape[1]
            or d_sq.shape != (d.shape[0],)):
        raise ValueError(f"l2_topk_scan_cuda shapes: q {tuple(q.shape)}, d "
                         f"{tuple(d.shape)}, d_sq {tuple(d_sq.shape)}")
    if not all(t.is_contiguous() for t in (q, d, d_sq)):
        raise ValueError("l2_topk_scan_cuda takes contiguous tensors")
    nq, dim = q.shape
    n = d.shape[0]
    if dim < 1 or n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError(f"l2_topk_scan_cuda shapes out of range: Q={nq}, "
                         f"N={n}, dim={dim}")
    lib = _lib()
    config, bq, cap = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if k < 1 or lib.l2_topk_plan(k, ctypes.byref(config), ctypes.byref(bq),
                                 ctypes.byref(cap)) != 0:
        raise ValueError(f"l2_topk kernel supports 1 <= k <= {max_k()} (a "
                         f"shared-memory buffer of 4096 pairs per query "
                         f"holds k pairs and one 64-row tile), got k={k}")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, chunks = plan_chunks(nq, n, k, bq.value, n_sms)
    vals = torch.empty((nq, k), device=dev, dtype=torch.float32)
    ids = torch.empty((nq, k), device=dev, dtype=torch.int32)
    part_v = part_i = None
    if chunks > 1:
        part_v = torch.empty((nq, chunks, k), device=dev, dtype=torch.float32)
        part_i = torch.empty((nq, chunks, k), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.l2_topk_launch(
        q.data_ptr(), d.data_ptr(), d_sq.data_ptr(), nq, n, dim, k, chunk,
        chunks, None if part_v is None else part_v.data_ptr(),
        None if part_i is None else part_i.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"l2_topk kernel launch failed (cuda error {err})")
    if nq:
        _build.count_launch(l2_topk_scan_cuda)
    return vals, ids


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
l2_topk_scan_cuda.launches = 0
