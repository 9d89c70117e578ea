"""Binding of the hand-written CUDA scan + top-k (``csrc/l2_topk.cu``).

Replaces the TPU kernel ``l2_topk_pallas``
(``src/repro/kernels/l2_topk/kernel.py``); the source file says how it is
laid out and what bounds it. The wrapper checks what the kernel takes,
schedules a pilot over a sample of the rows and the main pass
(:func:`schedule`), plans the chunks of rows and where the survivor lists
live (:func:`plan`), allocates the outputs and the lists, launches on PyTorch's current stream and raises if a
launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import GROUP

#: The kernel's geometry (``kBQ``, ``kBN``, ``kMaxK`` of the source).
QUERY_TILE = 64
ROW_TILE = 256
MAX_K = 4032
#: Shared memory of a scan block before its lists: a 3-stage ring of (64 +
#: 256) slice rows of 36 floats, and a 256-bin histogram a warp.
RING_SMEM = 4 * 3 * (QUERY_TILE + ROW_TILE) * 36 + 4 * 8 * 256
#: Margin for the scan kernel's static shared memory (thresholds, counts,
#: the block select's scalars: under 2 KB).
STATIC_SMEM = 4096
#: The pilot scans every PILOT_STEP-th row, when that sample holds at least
#: 2k rows.
PILOT_STEP = 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("l2_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l2_topk_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, i, i, i, i,
                                   i, p, p, p, p, p, p, p, p]
    lib.l2_topk_launch.restype = i
    lib.l2_topk_scan_smem.argtypes = [i, i]
    lib.l2_topk_scan_smem.restype = ctypes.c_longlong
    for name in ("l2_topk_max_k", "l2_topk_query_tile", "l2_topk_row_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    if (lib.l2_topk_query_tile(), lib.l2_topk_row_tile(),
            lib.l2_topk_max_k(), lib.l2_topk_scan_smem(1, 0)) != (
                QUERY_TILE, ROW_TILE, MAX_K, RING_SMEM):
        raise RuntimeError("l2_topk: the library's geometry differs from "
                           "the wrapper's")
    return lib


def max_k() -> int:
    """Largest k the kernel takes: pass 2 sorts a query's k pairs in one
    block's shared memory (4096 at most)."""
    return MAX_K


def list_cap(k: int) -> int:
    """A survivor list is cut back to k pairs when it passes this many: 2k
    + 32 (at least 128, a multiple of 32), so a cut drops at least k + 32."""
    return max(128, -(-(2 * k + GROUP) // GROUP) * GROUP)


def plan(n_queries: int, n_rows: int, k: int, n_sms: int,
         smem_limit: int) -> tuple[int, int, bool, int, int]:
    """(rows per chunk, chunks, lists in shared memory, list cap, cut
    point) for pass 1: one block an SM, blocks = query tiles x chunks, a
    chunk a whole number of row tiles. The 64 lists of a block stay in its
    shared memory when they fit there (cap = cut point = :func:`list_cap`;
    a warp cuts its own list when a group of 32 would overflow it);
    otherwise they live in device memory with room for one more tile (cap =
    cut point + 256), and the block cuts each list past the cut point
    after each tile, staged in shared memory."""
    q_tiles = -(-max(n_queries, 1) // QUERY_TILE)
    tiles = max(1, -(-n_rows // ROW_TILE))
    per = -(-tiles // min(max(1, n_sms // q_tiles), tiles))
    chunk = per * ROW_TILE
    chunks = max(1, -(-n_rows // chunk))
    cut = list_cap(k)
    if RING_SMEM + 8 * QUERY_TILE * cut + STATIC_SMEM <= smem_limit:
        return chunk, chunks, True, cut, cut
    return chunk, chunks, False, cut + ROW_TILE, cut


def schedule(n_queries: int, n_rows: int, k: int, n_sms: int,
             smem_limit: int) -> list[tuple[int, int, tuple]]:
    """The launches of one call, as (scan rows, row step, :func:`plan`):
    pilots over every ``PILOT_STEP ** j``-th row, coarsest first, for each
    j whose sample holds 2k rows or more (at most 2), then the main pass
    over every row. Each pass seeds its lists' thresholds with the k-th
    pair of the pass before it: that is the k-th best of a subset of the
    rows it scans, so a lower bound of their k-th best, and nothing it
    drops could be in the answer. Without a seed a chunk's threshold is the
    k-th best of the rows its list has seen, and at k = 2048 against chunks
    of 30k rows about a third of the scores pass it; with one, about
    ``PILOT_STEP`` * k a query."""
    out = [(n_rows, 1, plan(n_queries, n_rows, k, n_sms, smem_limit))]
    step = PILOT_STEP
    while len(out) < 3 and -(-n_rows // step) >= 2 * k:
        sample = -(-n_rows // step)
        out.insert(0, (sample, step,
                       plan(n_queries, sample, k, n_sms, smem_limit)))
        step *= PILOT_STEP
    return out


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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk kernel supports 1 <= k <= {MAX_K} (pass "
                         f"2 sorts a query's k pairs in shared memory), got "
                         f"k={k}")
    lib = _lib()
    props = torch.cuda.get_device_properties(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    seed = None
    for n_scan, step, (chunk, chunks, smem_lists, cap, cut) in schedule(
            nq, n, k, props.multi_processor_count,
            props.shared_memory_per_block_optin):
        lists = -(-nq // QUERY_TILE) * chunks * QUERY_TILE
        vals = torch.empty((nq, k), device=dev, dtype=torch.float32)
        ids = torch.empty((nq, k), device=dev, dtype=torch.int32)
        part_v = torch.empty(lists * k, device=dev, dtype=torch.float32)
        part_i = torch.empty(lists * k, device=dev, dtype=torch.int32)
        counts = torch.empty(lists, device=dev, dtype=torch.int32)
        list_v = list_i = None
        if not smem_lists:
            list_v = torch.empty(lists * cap, device=dev, dtype=torch.float32)
            list_i = torch.empty(lists * cap, device=dev, dtype=torch.int32)
        err = lib.l2_topk_launch(
            q.data_ptr(), d.data_ptr(), d_sq.data_ptr(), nq, n_scan, dim, k,
            step, None if seed is None else seed[0].data_ptr(),
            None if seed is None else seed[1].data_ptr(), chunk, chunks,
            int(smem_lists), cap, cut,
            None if list_v is None else list_v.data_ptr(),
            None if list_i is None else list_i.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), counts.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"l2_topk kernel launch failed (cuda error "
                               f"{err})")
        seed = vals, ids
    if nq:
        _build.count_launch(l2_topk_scan_cuda)
    return vals, ids


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
l2_topk_scan_cuda.launches = 0
